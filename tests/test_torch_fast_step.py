"""The per-pass renderer against the JAX package: the port's ``make_step``
with ``use_megakernel=False`` (layered: seven raster passes, the two-layer
stack, the stack shade and the composite) and with
``layered_shading=False`` (per-pass shading and blending, channel-last
bloom) against JAX ``make_step(renderer="tpu")`` (the Pallas kernels in
interpret mode) on the synthetic model at 128x64, physics on, for three
frames; the second frame sets a morph weight and starts a bone tween. Also
the plain torch modules of the non-layered branch, ``shading_fast`` and
the channel-last bloom of ``post``, on seeded inputs.

Bounds: frames within 1/255 on >= 99 % of pixels (the texture and its u
seam as in ``test_torch_step.py``); ``time`` and ``pair_overflow`` exact;
material parameters exact (an index gather selects the same rows as the
reference's one-hot product); shaded rgb within 1e-5 and bloom within
2e-6 (float sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import testing as jtesting
from reze_tpu.core.types import EngineConfig
from reze_tpu.kernels import raster_tpu as RT
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import post as jpost
from reze_tpu.render import shading_fast as JSF
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.render import post as ppost
from reze_tpu_torch.render import shading_fast as PSF
from test_torch_frame import _one_thread  # noqa: F401
from test_torch_step import N_FRAMES, H, W, run_frames

BRANCHES = {"layered": {"use_megakernel": False}, "per_pass": {"layered_shading": False}}


@pytest.fixture(scope="module", params=sorted(BRANCHES))
def runs(request):
    return run_frames(**BRANCHES[request.param])


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_fast_step_frame_matches(runs, f):
    ref, port = runs[f]["jframe"], runs[f]["pframe"]
    assert port.shape == ref.shape == (H, W, 3)
    assert np.isfinite(port).all()
    diff = np.abs(port - ref).max(-1)
    assert (diff <= 1.0 / 255.0).mean() >= 0.99, (diff > 1 / 255).mean()
    assert (ref.sum(-1) > 0.01).mean() > 0.05  # the scene draws


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_fast_step_state_matches(runs, f):
    js, ps = runs[f]["jstate"], runs[f]["pstate"]
    assert ps.time.item() == float(js.time)
    assert ps.diag.pair_overflow.item() == int(js.diag.pair_overflow) == 0
    if f:
        assert np.abs(runs[f]["pframe"] - runs[0]["pframe"]).max() > 0.1  # pose moves


# ---------------------------------------------------------------------------
# shading_fast and the channel-last bloom
# ---------------------------------------------------------------------------

GH, GW = 32, 64  # G-buffer frame of the shading checks
ODD = (127, 63)  # bloom at an odd size: 63x31 at half size, resized back


def _random_gbuf(seed, n_mats):
    rng = np.random.default_rng(seed)
    p = GH * GW
    g = np.zeros((RT.N_CH, p), np.float32)
    iw = rng.uniform(0.5, 2.0, p)
    g[RT.CH_UIW] = rng.uniform(-1.5, 2.5, p) * iw
    g[RT.CH_VIW] = rng.uniform(-1.5, 2.5, p) * iw
    g[RT.CH_NXIW:RT.CH_NZIW + 1] = rng.normal(size=(3, p)) * iw
    g[RT.CH_IW] = iw
    g[RT.CH_MAT] = rng.integers(-1, n_mats, p)
    g[RT.CH_COVER] = rng.integers(0, 5, p) * 0.25
    g[RT.CH_Z] = rng.uniform(0.05, 0.95, p)
    stencil = rng.integers(0, 2, p).astype(np.int32)
    return g, stencil


@pytest.fixture(scope="module")
def shading():
    """Both packages' shading_fast and bloom outputs (one JAX compile)."""
    jmodel = jtesting.make_test_model()
    pmodel = ptesting.make_test_model(device="cpu")
    jpacked = JSF.pack_materials(jmodel.materials, jmodel.atlas)
    ppacked = PSF.pack_materials(pmodel.materials, pmodel.atlas)
    g, stencil = _random_gbuf(3, jmodel.materials.alpha.shape[0])
    rng = np.random.default_rng(4)
    color = rng.uniform(0, 1, (GH * GW, 3)).astype(np.float32)
    odd = rng.uniform(0, 2, ODD + (3,)).astype(np.float32)
    even = rng.uniform(0, 2, (64, 128, 3)).astype(np.float32)
    eye = np.float32([0.3, 1.5, -4.0])
    inv_vp = np.linalg.inv(rng.normal(size=(4, 4))).astype(np.float32)
    jlights = jpipe.make_lights(EngineConfig())
    stride = jmodel.atlas.texels.shape[2]

    @jax.jit
    def ref(table, g, stencil, color, odd, even, lights, eye, inv_vp):
        packed = jpacked._replace(table=table)
        params = JSF.fetch_params(jnp.maximum(g[RT.CH_MAT], 0.0), packed)
        mat = JSF.shade_material_fast(g, packed, stride, lights, eye, inv_vp, GW, GH, 0.45,
                                      stencil=stencil, stencil_eye_value=1)
        outline = JSF.shade_outline_fast(g, packed)
        return dict(
            params=params, mat=mat, outline=outline,
            blend=JSF.blend(color, *mat), blend_outline=JSF.blend(color, *outline),
            toon=JSF.eval_toon(params[:, 11:38].reshape(-1, 9, 3), g[RT.CH_COVER]),
            down=jpost.downsample2x(odd), blur=jpost.gaussian_blur(odd),
            up_odd=jpost.upsample2x(odd[:ODD[0] // 2, :ODD[1] // 2], *ODD),
            up_even=jpost.upsample2x(even[:32, :64], 64, 128),
            bloom_odd=jpost.apply_bloom(odd, 0.6, 0.8),
            bloom_even=jpost.apply_bloom(even, 0.6, 0.8))

    jres = jax.device_get(ref(jpacked.table, g, stencil, color, odd, even, jlights, eye,
                              inv_vp))
    t = torch.as_tensor
    plights = bridge.from_jax_arrays(jax.device_get(jlights), "cpu")
    pg = t(g)
    params = PSF.fetch_params(torch.clamp(pg[RT.CH_MAT], min=0.0), ppacked)
    mat = PSF.shade_material_fast(pg, ppacked, stride, plights, t(eye), t(inv_vp), GW, GH,
                                  0.45, stencil=t(stencil), stencil_eye_value=1)
    outline = PSF.shade_outline_fast(pg, ppacked)
    pres = dict(
        params=params, mat=mat, outline=outline,
        blend=PSF.blend(t(color), *mat), blend_outline=PSF.blend(t(color), *outline),
        toon=PSF.eval_toon(params[:, 11:38].reshape(-1, 9, 3), pg[RT.CH_COVER]),
        down=ppost.downsample2x(t(odd)), blur=ppost.gaussian_blur(t(odd)),
        up_odd=ppost.upsample2x(t(odd[:ODD[0] // 2, :ODD[1] // 2]), *ODD),
        up_even=ppost.upsample2x(t(even[:32, :64]), 64, 128),
        bloom_odd=ppost.apply_bloom(t(odd), 0.6, 0.8),
        bloom_even=ppost.apply_bloom(t(even), 0.6, 0.8))
    return jres, pres, (np.asarray(jpacked.table), ppacked.table.numpy())


def test_pack_materials_and_fetch_params_match(shading):
    jres, pres, (jtab, ptab) = shading
    np.testing.assert_array_equal(ptab, jtab)
    np.testing.assert_array_equal(pres["params"].numpy(), np.asarray(jres["params"]))


@pytest.mark.parametrize("name", ["mat", "outline", "blend", "blend_outline", "toon"])
def test_shading_fast_matches(shading, name):
    jres, pres, _ = shading
    ref, port = jres[name], pres[name]
    if isinstance(port, torch.Tensor):
        ref, port = (ref,), (port,)
    for r, p in zip(ref, port):
        r, p = np.asarray(r), p.numpy()
        assert p.shape == r.shape
        if p.dtype == np.bool_:
            np.testing.assert_array_equal(p, r)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["down", "blur", "up_odd", "up_even", "bloom_odd",
                                  "bloom_even"])
def test_bloom_chain_matches(shading, name):
    jres, pres, _ = shading
    ref, port = np.asarray(jres[name]), pres[name].numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=2e-6)
