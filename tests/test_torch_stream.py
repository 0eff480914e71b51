"""The stream frame megakernel's pair pack, plain torch twin and compose
against the JAX package (``frame_stream``, the kernel in interpret mode),
and the stream path's frame.

* Pack: ``pipeline_gpu._build_stream_tables`` against
  ``pipeline_tpu._build_stream_tables`` on the synthetic model at 256x64
  (both eager). ``bounds`` and ``overflow`` equal; the row columns the
  kernel reads (planes, material code, attribute planes) mapped between
  the port's 40-wide layout and the JAX stream layout, within the pack
  tests' bound (rtol 1e-6, atol 1e-5: the port sums the attribute planes
  in float64).
* Kernel: the twin against ``render_megakernel_stream(interpret=True)`` on
  the seeded random tables of ``test_torch_frame.py`` merged into one
  stream (16x256; a tile's stream spans many 128-pair windows). Per pass,
  the winner keys equal on >= 99.5 % of pixels (a sample or a key within
  a rounding of its decision may go the other way: XLA's CPU backend fuses
  the plane products, the port rounds each); where they are equal, the
  summed coverage and the 19 fragment values equal exactly.
* Compose: ``compose_stream_state`` against JAX's on the same raw state:
  equal in the depth, ``a_eff``, outline and group-id channels; the six
  attributes ``(a*x + b*y) + c`` at the pixel centre within 4 ulps of the
  plane's largest term (XLA's CPU backend fuses the products, the port
  rounds each: 7.6e-6 at most on these tables, where terms reach 1e2).
* Path: ``render_frame_mega`` with ``rasterizer="stream"``, as in
  ``test_torch_step.mega_frames``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import camera as jcam
from reze_tpu import testing as jtesting
from reze_tpu.core import types as JT
from reze_tpu.kernels import frame_stream as JFS
from reze_tpu.kernels import frame_tpu as FT
from reze_tpu.kernels import shade_tpu as ST
from reze_tpu.render import pipeline_tpu
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import frame_stream as FS
from reze_tpu_torch.kernels import shade_gpu as SG
from reze_tpu_torch.render import pipeline_gpu
from test_torch_frame import HP, N_TRIS, WP, _one_thread  # noqa: F401
from test_torch_step import TEX_HW, bind_pose, check_mega_frames, mega_frames

N_SAMPLES = 4
# port row column -> JAX stream row column
COL_MAP = ([(c, c) for c in range(12)] + [(FG.C_ALPHA, JFS.SC_CODE)]
           + [(FG.C_ATTR + c, JFS.SC_ATTR + c) for c in range(18)])


def jax_stream_tables(st):
    """Port StreamTables -> JAX's, with its row layout and plane table."""
    rows = st.rows.numpy()
    n = rows.shape[0]
    out = np.zeros((n, FT.ROW_W), np.float32)
    for pc, jc in COL_MAP:
        out[:, jc] = rows[:, pc]
    out[:, JFS.SC_ONES] = np.arange(n) < int(st.bounds[7].max())  # live rows
    qd = out[:, :12].reshape(n // FT.CHUNK, FT.CHUNK, 4, 3).transpose(3, 0, 2, 1)
    quad = np.concatenate([qd.reshape(3, n * 4), np.zeros((5, n * 4), np.float32)])
    return JFS.StreamTables(rows=jnp.asarray(out), quad=jnp.asarray(quad),
                            bounds=jnp.asarray(st.bounds.numpy()),
                            overflow=jnp.int32(int(st.overflow)))


def planar(raw_pm, hp, wp):
    """JAX's pixel-major raw state -> planar (S_OUT, hp, wp)."""
    st = raw_pm.reshape(hp // 8, wp // 128, 8, 128, JFS.S_OUT)
    return st.transpose(4, 0, 2, 1, 3).reshape(JFS.S_OUT, hp, wp)


@pytest.fixture(scope="module")
def kernel_case():
    st = ptesting.random_stream_tables(11, N_TRIS, HP, WP, device="cpu")
    jst = jax_stream_tables(st)
    raw_pm = np.asarray(jax.jit(lambda t: JFS.render_megakernel_stream(
        t, hp=HP, wp=WP, n_samples=N_SAMPLES, interpret=True))(jst))
    port = FS.render_megakernel_stream(st, hp=HP, wp=WP, n_samples=N_SAMPLES).numpy()
    return st, raw_pm, planar(raw_pm, HP, WP), port


@pytest.mark.parametrize("p", range(FS.N_PASSES))
def test_stream_twin_matches_pallas(kernel_case, p):
    st, _, ref, port = kernel_case
    span = (st.bounds[7] - st.bounds[0]).numpy()
    assert span.max() > 2 * FS.WINDOW  # a tile's stream spans several windows
    assert port.shape == ref.shape == (FS.S_OUT, HP, WP)
    kp = port[FS.O_BEST + p].view(np.int32)
    kr = ref[FS.O_BEST + p].view(np.int32)
    same = kp == kr
    assert same.mean() >= ptesting.SAME_FRAC, same.mean()
    assert (kr < FS.SENTINEL).mean() > 0.1  # the pass draws
    np.testing.assert_array_equal(port[FS.O_COVER + p][same], ref[FS.O_COVER + p][same])
    fb = FS.O_FRAG + p * FS.N_FRAG
    for c in range(FS.N_FRAG):
        np.testing.assert_array_equal(port[fb + c][same], ref[fb + c][same])


@pytest.mark.parametrize("layer", [0, 1])
def test_compose_matches(kernel_case, layer):
    _, raw_pm, ref_raw, _ = kernel_case
    want = np.asarray(jax.jit(lambda r: JFS.compose_stream_state(r, HP, WP, N_SAMPLES))(
        jnp.asarray(raw_pm)))
    got = FS.compose_stream_state(torch.as_tensor(ref_raw), N_SAMPLES).numpy()
    assert got.shape == want.shape == (2 * SG.L_CH, HP, WP)
    b = layer * SG.L_CH
    assert (want[b + SG.L_AEFF] > 0).mean() > 0.1  # the layer is drawn
    for ch in (SG.L_Z, SG.L_AEFF, SG.L_OUT, SG.L_RAMP, SG.L_TEX, SG.L_EDGE):
        np.testing.assert_array_equal(got[b + ch], want[b + ch])
    px = np.arange(WP, dtype=np.float32) + 0.5
    py = np.arange(HP, dtype=np.float32)[:, None] + 0.5
    for c in range(6):
        term = np.zeros((HP, WP), np.float32)  # largest plane term of any pass
        for p in range(FS.N_PASSES):
            fb = FS.O_FRAG + p * FS.N_FRAG
            term = np.maximum.reduce([term, np.abs(ref_raw[fb + 1 + c] * px),
                                      np.abs(ref_raw[fb + 7 + c] * py),
                                      np.abs(ref_raw[fb + 13 + c])])
        d = np.abs(got[b + SG.L_UIW + c] - want[b + SG.L_UIW + c])
        assert (d <= 4 * 2.0 ** -23 * term).all(), d.max()


def test_pack_stream_matches():
    w, h = 256, 64
    jmodel = jtesting.make_test_model(tex_hw=TEX_HW)
    pmodel = ptesting.make_test_model(tex_hw=TEX_HW, device="cpu")
    jcfg = JT.EngineConfig(width=w, height=h, enable_physics=False, rasterizer="stream")
    pcfg = PT.EngineConfig(width=w, height=h, enable_physics=False, rasterizer="stream")
    cam = jcam.Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                      aspect=w / h)
    vp = np.array(cam.view_proj())
    pos, nrm = bind_pose(jmodel)
    jtabs = ST.pack_shade_tables(jmodel.materials, jmodel.atlas)
    jst = jax.jit(lambda pos, nrm, vp: pipeline_tpu._build_stream_tables(
        jmodel, jcfg, pipeline_tpu.make_dims_fast(jcfg), jtabs, pos, nrm, vp, None))(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(vp))
    t = torch.as_tensor
    pst = pipeline_gpu._build_stream_tables(
        pmodel, pcfg, pipeline_gpu.make_dims_fast(pcfg),
        SG.pack_shade_tables(pmodel.materials, pmodel.atlas), t(pos), t(nrm), t(vp), None)
    np.testing.assert_array_equal(pst.bounds.numpy(), np.asarray(jst.bounds))
    assert int(pst.overflow) == int(jst.overflow) == 0
    jrows = np.asarray(jst.rows)
    assert pst.rows.shape[0] == jrows.shape[0]
    n_live = int(pst.bounds[7].max())
    assert n_live > 0
    prows = pst.rows.numpy()
    for pc, jc in COL_MAP:
        np.testing.assert_allclose(prows[:, pc], jrows[:, jc], rtol=1e-6, atol=1e-5)


def test_stream_wrapper_uses_twin_on_cpu(kernel_case):
    """On CPU tensors the wrapper is the twin and counts no launch."""
    st = kernel_case[0]
    before = FS.render_megakernel_stream.launches
    a = FS.render_megakernel_stream(st, hp=HP, wp=WP, n_samples=2)
    b = FS.render_megakernel_stream_twin(st, hp=HP, wp=WP, n_samples=2)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert FS.render_megakernel_stream.launches == before


def test_stream_path_matches():
    check_mega_frames(*mega_frames("stream"))
