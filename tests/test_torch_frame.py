"""The frame megakernel's and the composite kernel's plain torch twins
against the JAX package's Pallas kernels in interpret mode, on the same
tables: seeded random triangles in a 16x256 frame (segments longer than
one chunk, overlapping and interpenetrating triangles, three texture, ramp
and edge groups).

Tolerances and why:

* the decoded texel index, ``a_eff`` and the texel footprint step are
  equal on >= 99.5 % of pixels. The rest are pixels where an edge or
  depth plane lands within a rounding of a decision: XLA's CPU backend
  fuses ``a*x + c`` into one rounding inside the jitted kernel, the port
  rounds the product first, so a sample at an edge or an exact z-tie can
  go the other way. Such a pixel still holds a valid result (an index
  into the atlas or -1, an ``a_eff`` in [0, 1]);
* lit rgb and rim agree within 1e-4 where both sides shaded the same
  fragment (same index and ``a_eff``);
* the composite (``test_torch_frame_analytic.py``) agrees within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.core.types import EngineConfig, Lights
from reze_tpu.kernels import frame_tpu as FT
from reze_tpu.kernels import shade_tpu as ST
from reze_tpu.render import pipeline as jpipe
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import shade_gpu as SG

HP, WP = 16, 256
N_TRIS = (400,) * 7
RIM = 0.45


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for a module that uses this (the port's CPU-heavy
    test modules import it): the suite runs them beside single-threaded JAX
    tests on the other workers, and torch's default of one thread per core
    would take every core from them in bursts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tables(ft, sh):
    rows = np.zeros((ft.rows.shape[0], FT.ROW_W), np.float32)
    rows[:, :FG.ROW_W] = ft.rows.numpy()
    jft = FT.FrameTables(rows=jnp.asarray(rows), rows_t=None,
                         starts=jnp.asarray(ft.starts.numpy()),
                         counts=jnp.asarray(ft.counts.numpy()),
                         overflow=jnp.int32(int(ft.overflow)))
    jsh = ST.ShadeTables(push_tab=jnp.zeros((1, 7)), knot_tab=jnp.asarray(sh["knot_tab"]),
                         tex_tab=jnp.asarray(sh["tex_tab"]),
                         edge_tab=jnp.asarray(sh["edge_tab"]),
                         atlas_flat=jnp.zeros((1, 4), jnp.uint8),
                         atlas_stride=sh["atlas_stride"])
    return jft, jsh


def _port_shade(sh):
    t = lambda k: torch.as_tensor(sh[k])  # noqa: E731
    return SG.ShadeTables(push_tab=torch.zeros((1, 7)), knot_tab=t("knot_tab"),
                          tex_tab=t("tex_tab"), edge_tab=t("edge_tab"),
                          atlas_stride=sh["atlas_stride"])


@pytest.fixture(scope="module")
def scene():
    ft = ptesting.random_frame_tables(11, N_TRIS, HP, WP, device="cpu")
    sh = ptesting.random_shade_inputs(5)
    jlights = jpipe.make_lights(EngineConfig())
    return dict(ft=ft, sh=sh, jlights=jlights,
                plights=bridge.from_jax_arrays(jax.device_get(jlights), "cpu"))


def frame_outputs(analytic, use_mips, lod_bias):
    """(JAX interpret-mode output, twin output) on the random tables."""
    ft = ptesting.random_frame_tables(11, N_TRIS, HP, WP, device="cpu")
    sh = ptesting.random_shade_inputs(5)
    jlights = jpipe.make_lights(EngineConfig())
    jft, jsh = _jax_tables(ft, sh)
    n = 1 if analytic else 4

    @jax.jit
    def ref(jft, knot, tex, edge, lights, eye, inv_vp):
        tabs = jsh._replace(knot_tab=knot, tex_tab=tex, edge_tab=edge)
        return FT.render_megakernel(jft, tabs, lights, RIM, eye, inv_vp, hp=HP, wp=WP,
                                    n_samples=n, interpret=True, use_mips=use_mips,
                                    lod_bias=lod_bias, analytic=analytic)

    o_ref = np.asarray(ref(jft, jsh.knot_tab, jsh.tex_tab, jsh.edge_tab, jlights,
                           jnp.asarray(sh["eye_pos"]), jnp.asarray(sh["inv_vp"])))
    o_port = FG.render_megakernel(
        ft, _port_shade(sh), bridge.from_jax_arrays(jax.device_get(jlights), "cpu"), RIM,
        torch.as_tensor(sh["eye_pos"]), torch.as_tensor(sh["inv_vp"]), hp=HP, wp=WP,
        n_samples=n, use_mips=use_mips, lod_bias=lod_bias, analytic=analytic).numpy()
    return o_ref, o_port


def check_frame(o_ref, o_port, layer):
    """The module docstring's bounds (``testing.compare_shade``) for one
    stack layer, plus the range of the pixels that differ. ``a_eff``
    counts as equal within 1e-5: in analytic mode it is a product of
    clamped edge distances, where the fused rounding shows in the last
    bits."""
    assert o_port.shape == o_ref.shape == (2 * SG.O_CH, HP, WP)
    res = ptesting.compare_shade(o_port, o_ref)
    b = layer * SG.O_CH
    same = res["same"][layer]
    assert same.mean() >= ptesting.SAME_FRAC, same.mean()
    idx_p = ptesting.decoded_index(o_port, layer)
    assert ((idx_p >= -1) & (idx_p < 3 * 16 * 16)).all()
    aeff_p = o_port[b + SG.O_AEFF]
    assert ((aeff_p >= 0) & (aeff_p <= 1)).all()
    for ch in (SG.O_LR, SG.O_LG, SG.O_LB, SG.O_RIM):
        np.testing.assert_allclose(o_port[b + ch][same], o_ref[b + ch][same],
                                   rtol=0, atol=ptesting.LIT_TOL)
    return int((o_ref[b + SG.O_AEFF] > 0).sum())


@pytest.fixture(scope="module")
def msaa_mips():
    return frame_outputs(analytic=False, use_mips=True, lod_bias=(1.0, 0.0))


@pytest.mark.parametrize("layer", [0, 1])
def test_frame_twin_matches_pallas_msaa_mips(msaa_mips, layer):
    covered = check_frame(*msaa_mips, layer)
    assert covered > HP * WP // 4  # the random scene covers the frame


def test_frame_wrapper_uses_twin_on_cpu(scene):
    """On CPU tensors the wrapper is the twin; the launch counter only
    counts kernel launches."""
    before = FG.render_megakernel.launches
    args = (scene["ft"], _port_shade(scene["sh"]), scene["plights"], RIM,
            torch.as_tensor(scene["sh"]["eye_pos"]), torch.as_tensor(scene["sh"]["inv_vp"]))
    kw = dict(hp=HP, wp=WP, n_samples=4, use_mips=True, lod_bias=(1.0, 0.0))
    a = FG.render_megakernel(*args, **kw)
    b = FG.render_megakernel_twin(*args, **kw)
    assert torch.equal(a, b)
    assert FG.render_megakernel.launches == before


def test_lights_bridge_matches():
    """Lights reach the kernels identically through the bridge."""
    jl = jpipe.make_lights(EngineConfig())
    pl = bridge.from_jax_arrays(jax.device_get(jl), "cpu")
    assert isinstance(jl, Lights)
    for name in ("ambient", "direction", "color", "intensity", "count"):
        np.testing.assert_array_equal(getattr(pl, name).numpy(), np.asarray(getattr(jl, name)))
