"""The mxu frame megakernel's plain torch twin against the JAX package's
Pallas kernel (``frame_mxu.render_megakernel_mxu``) in interpret mode, on
the seeded random tables of ``test_torch_frame.py`` (16x256, segments
longer than one 128-pair window), with 4 samples and with 2.

The JAX tables add the TPU kernel's coefficient-major plane table
(``rows_t``), built here as ``pipeline_tpu._build_group_tables`` builds
it, and its pixel-major stack is laid out planar as
``pipeline_tpu.render_frame_mega`` does.

Bounds, per stack layer: ``a_eff``, the outline flag and the ramp,
texture and edge group ids equal on >= 99.5 % of pixels (a sample or a
key within a rounding of its decision may go the other way: XLA's CPU
backend fuses the plane products, the port rounds each). Where they are
equal, the depth (the winner key's quantised depth) is within one key
step, 2^-18 (the centre depth that the key quantises lies within a
rounding of a step boundary on a few pixels), and the six attributes
within ``testing.RASTER_TOL`` (rtol and atol), as the raster-pass tests
bound them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reze_tpu.kernels import frame_mxu as JFM
from reze_tpu.kernels import frame_tpu as FT
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import frame_mxu as FM
from reze_tpu_torch.kernels import shade_gpu as SG
from test_torch_step import check_mega_frames, mega_frames
from test_torch_frame import HP, N_TRIS, WP, _one_thread  # noqa: F401

EXACT = (SG.L_AEFF, SG.L_OUT, SG.L_RAMP, SG.L_TEX, SG.L_EDGE)


def jax_tables(ft):
    rows = np.zeros((ft.rows.shape[0], FT.ROW_W), np.float32)
    rows[:, :FG.ROW_W] = ft.rows.numpy()
    n = rows.shape[0]
    q = rows[:, :12].reshape(n // FT.CHUNK, FT.CHUNK, 4, 3)
    q = q.transpose(3, 0, 2, 1).reshape(3, n * 4)
    rows_t = np.concatenate([q, np.zeros((5, n * 4), np.float32)], axis=0)
    return FT.FrameTables(rows=jnp.asarray(rows), rows_t=jnp.asarray(rows_t),
                          starts=jnp.asarray(ft.starts.numpy()),
                          counts=jnp.asarray(ft.counts.numpy()),
                          overflow=jnp.int32(int(ft.overflow)))


def outputs(n_samples):
    ft = ptesting.random_frame_tables(11, N_TRIS, HP, WP, device="cpu")
    pm = jax.jit(lambda t: JFM.render_megakernel_mxu(t, hp=HP, wp=WP, n_samples=n_samples,
                                                     interpret=True))(jax_tables(ft))
    ref = np.asarray(pm).reshape(HP // 8, WP // 128, 8, 128, 2 * SG.L_CH)
    ref = ref.transpose(4, 0, 2, 1, 3).reshape(2 * SG.L_CH, HP, WP)
    port = FM.render_megakernel_mxu(ft, hp=HP, wp=WP, n_samples=n_samples).numpy()
    return ref, port, ft


@pytest.fixture(scope="module", params=[4, 2])
def case(request):
    return outputs(request.param)


@pytest.mark.parametrize("layer", [0, 1])
def test_mxu_twin_matches_pallas(case, layer):
    ref, port, _ = case
    assert port.shape == ref.shape == (2 * SG.L_CH, HP, WP)
    b = layer * SG.L_CH
    same = np.ones((HP, WP), bool)
    for ch in EXACT:
        same &= port[b + ch] == ref[b + ch]
    assert same.mean() >= ptesting.SAME_FRAC, same.mean()
    assert (ref[b + SG.L_AEFF] > 0).mean() > 0.1  # the layer is drawn
    dz = np.abs(port[b + SG.L_Z] - ref[b + SG.L_Z])[same]
    assert (dz <= 1.0 / FM.ZQ).all(), dz.max()
    for ch in range(SG.L_UIW, SG.L_IW + 1):
        d = np.abs(port[b + ch] - ref[b + ch])[same]
        assert (d <= ptesting.RASTER_TOL * (1.0 + np.abs(ref[b + ch])[same])).all(), d.max()


def test_mxu_path_matches():
    """``render_frame_mega`` with ``rasterizer="mxu"``, port against JAX on
    the synthetic model (``test_torch_step.mega_frames``): >= 99 % of
    pixels within 1/255, pair overflow equal."""
    check_mega_frames(*mega_frames("mxu"))
