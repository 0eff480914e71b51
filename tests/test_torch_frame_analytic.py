"""The frame megakernel's twin in analytic-coverage mode with mips off
against the Pallas kernel in interpret mode, and the composite kernel's
twin against the JAX albedo gather + Pallas composite. A separate file
from ``test_torch_frame.py`` because each JAX compile of the frame kernel
takes tens of seconds on the CPU. Tables, bounds and their reasons are
those of ``test_torch_frame.py``; the composite agrees within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.kernels import composite_tpu as CT
from reze_tpu.kernels import shade_tpu as ST
from reze_tpu.render import pipeline_tpu
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import composite_gpu as CG
from test_torch_frame import HP, WP, _one_thread, check_frame, frame_outputs  # noqa: F401


@pytest.fixture(scope="module")
def analytic_nomips():
    return frame_outputs(analytic=True, use_mips=False, lod_bias=(0.0, 0.0))


@pytest.mark.parametrize("layer", [0, 1])
def test_frame_twin_matches_pallas_analytic(analytic_nomips, layer):
    covered = check_frame(*analytic_nomips, layer)
    assert covered > HP * WP // 4


@pytest.mark.parametrize("half", [(True, True), (False, True), (False, False)])
def test_composite_twin_matches_pallas(analytic_nomips, half):
    """Shade outputs of the random scene, stacked to 32 rows (the Pallas
    composite works on 32-row tiles), through both composites."""
    _, o = analytic_nomips
    o = np.ascontiguousarray(np.concatenate([o, o[:, ::-1]], axis=1))
    hp = o.shape[1]
    atlas = ptesting.random_shade_inputs(5)["texels"].reshape(-1, 4)
    dims = pipeline_tpu.FastDims(WP, hp, WP, hp, WP // 128, hp // 32)

    @jax.jit
    def ref(o, atlas):
        of = o.reshape(2 * ST.O_CH, hp * WP)
        a0 = pipeline_tpu._albedo_u32(atlas, of, 0, dims, half_res=half[0])
        a1 = pipeline_tpu._albedo_u32(atlas, of, ST.O_CH, dims, half_res=half[1])
        return CT.composite_tpu(o, a0, a1, with_bloom=True, interpret=True)

    img_r, half_r = ref(jnp.asarray(o), jnp.asarray(atlas))
    before = CG.composite.launches
    img_p, half_p = CG.composite(torch.as_tensor(o), torch.as_tensor(atlas),
                                 half0=half[0], half1=half[1], with_bloom=True)
    assert CG.composite.launches == before  # CPU tensors run the twin
    np.testing.assert_allclose(img_p.numpy(), np.asarray(img_r), rtol=0, atol=1e-6)
    np.testing.assert_allclose(half_p.numpy(), np.asarray(half_r), rtol=0, atol=1e-6)
    assert (np.asarray(img_r) > 0.05).mean() > 0.3  # textured, lit pixels
