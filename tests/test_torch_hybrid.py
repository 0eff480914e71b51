"""The hybrid frame megakernel's plain torch twin against the JAX
package's Pallas kernel (``frame_hybrid.render_megakernel_hybrid``) in
interpret mode, on the seeded random tables of ``test_torch_frame.py``
(16x256, segments longer than one 128-pair chunk), with 4x MSAA and mips
and in analytic mode.

The JAX rows are the port's rows padded to 128 columns with the TPU
kernel's coefficient blocks (columns 64:96: each edge plane times its
``1/|grad e|``, then the depth plane), built here as the JAX package's
pack builds them.

Bounds (``testing.compare_shade``): the decoded texel index, ``a_eff``
and the footprint step equal on >= 99.5 % of each layer's pixels, lit rgb
and rim within 1e-4 there. The TPU kernel evaluates planes as matrix
products over a three-way bfloat16 split of the coefficients; the port in
float32 with each product rounded, so an edge sample or a z-tie within a
rounding of its decision may go the other way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.kernels import frame_hybrid as JFH
from reze_tpu.kernels import frame_tpu as FT
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import frame_hybrid as FH
from reze_tpu_torch.kernels import shade_gpu as SG
from test_torch_step import check_mega_frames, mega_frames
from test_torch_frame import (HP, N_TRIS, RIM, WP, _jax_tables, _one_thread,  # noqa: F401
                              _port_shade)


def hybrid_rows(rows: np.ndarray) -> np.ndarray:
    """Port rows (N, 40) -> the TPU layout (N, 128) with columns 64:96."""
    out = np.zeros((rows.shape[0], FT.ROW_W), np.float32)
    out[:, :FG.ROW_W] = rows
    for i in range(3):
        ig = rows[:, FG.C_IGRAD + i]
        for k in range(3):
            out[:, FT.C_HYB + 8 * i + k] = rows[:, 3 * i + k] * ig
    out[:, FT.C_HYB + 24:FT.C_HYB + 27] = rows[:, FG.C_Z:FG.C_Z + 3]
    return out


def outputs(analytic, use_mips):
    ft = ptesting.random_frame_tables(11, N_TRIS, HP, WP, device="cpu")
    sh = ptesting.random_shade_inputs(5)
    from reze_tpu.core.types import EngineConfig
    from reze_tpu.render import pipeline as jpipe

    jlights = jpipe.make_lights(EngineConfig())
    jft, jsh = _jax_tables(ft, sh)
    jft = jft._replace(rows=jnp.asarray(hybrid_rows(ft.rows.numpy())))
    n = 1 if analytic else 4
    kw = dict(hp=HP, wp=WP, n_samples=n, use_mips=use_mips, lod_bias=(1.0, 0.0),
              analytic=analytic)

    @jax.jit
    def ref(jft, knot, tex, edge, lights, eye, inv_vp):
        tabs = jsh._replace(knot_tab=knot, tex_tab=tex, edge_tab=edge)
        return JFH.render_megakernel_hybrid(jft, tabs, lights, RIM, eye, inv_vp,
                                            interpret=True, **kw)

    o_ref = np.asarray(ref(jft, jsh.knot_tab, jsh.tex_tab, jsh.edge_tab, jlights,
                           jnp.asarray(sh["eye_pos"]), jnp.asarray(sh["inv_vp"])))
    plights = bridge.from_jax_arrays(jax.device_get(jlights), "cpu")
    o_port = FH.render_megakernel_hybrid(
        ft, _port_shade(sh), plights, RIM, torch.as_tensor(sh["eye_pos"]),
        torch.as_tensor(sh["inv_vp"]), **kw).numpy()
    return o_ref, o_port


@pytest.fixture(scope="module", params=["msaa_mips", "analytic"])
def case(request):
    return outputs(analytic=request.param == "analytic",
                   use_mips=request.param == "msaa_mips")


@pytest.mark.parametrize("layer", [0, 1])
def test_hybrid_twin_matches_pallas(case, layer):
    o_ref, o_port = case
    assert o_port.shape == o_ref.shape == (2 * SG.O_CH, HP, WP)
    res = ptesting.compare_shade(o_port, o_ref)
    same = res["same"][layer]
    assert same.mean() >= ptesting.SAME_FRAC, same.mean()
    b = layer * SG.O_CH
    for ch in (SG.O_LR, SG.O_LG, SG.O_LB, SG.O_RIM):
        np.testing.assert_allclose(o_port[b + ch][same], o_ref[b + ch][same],
                                   rtol=0, atol=ptesting.LIT_TOL)
    aeff = o_port[b + SG.O_AEFF]
    assert ((aeff >= 0) & (aeff <= 1)).all()
    assert (o_ref[b + SG.O_AEFF] > 0).sum() > HP * WP // 8  # the layer is drawn


def test_hybrid_path_matches():
    """``render_frame_mega`` with ``rasterizer="hybrid"``, port against JAX on
    the synthetic model (``test_torch_step.mega_frames``): >= 99 % of
    pixels within 1/255, pair overflow equal."""
    check_mega_frames(*mega_frames("hybrid"))
