"""The CUDA kernels against their plain torch twins on the card, and the
whole step on the GPU against the step on the CPU. Marked ``cuda``: every
test skips without a CUDA device. Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest``: the suite's conftest imports jax).

Bounds are those of the CPU parity tests (``testing.compare_shade`` for
the frame kernel, 1e-6 for the composite, 1/255 on 99 % of pixels for a
frame)."""

import numpy as np
import pytest
import torch

from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.camera import Camera
from reze_tpu_torch.core.types import EngineConfig, init_scene_state
from reze_tpu_torch.kernels import composite_gpu as CG
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import shade_gpu as SG
from reze_tpu_torch.render import pipeline
from reze_tpu_torch.step import make_step

pytestmark = pytest.mark.cuda

HP, WP = 16, 256
N_TRIS = (400,) * 7


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _shade_args(dev):
    sh = ptesting.random_shade_inputs(5)
    t = lambda k: torch.as_tensor(sh[k], device=dev)  # noqa: E731
    tables = SG.ShadeTables(push_tab=torch.zeros((1, 7), device=dev), knot_tab=t("knot_tab"),
                            tex_tab=t("tex_tab"), edge_tab=t("edge_tab"),
                            atlas_stride=sh["atlas_stride"])
    return tables, pipeline.make_lights(EngineConfig(), dev), t("eye_pos"), t("inv_vp")


@pytest.mark.parametrize("analytic,use_mips,n", [(False, True, 4), (True, False, 1),
                                                 (False, False, 2)])
def test_frame_kernel_matches_twin(dev, analytic, use_mips, n):
    ft = ptesting.random_frame_tables(11, N_TRIS, HP, WP, device=dev)
    tables, lights, eye, inv_vp = _shade_args(dev)
    kw = dict(hp=HP, wp=WP, n_samples=n, use_mips=use_mips, lod_bias=(1.0, 0.0),
              analytic=analytic)
    before = FG.render_megakernel.launches
    got = FG.render_megakernel(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    want = FG.render_megakernel_twin(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    torch.cuda.synchronize()
    assert FG.render_megakernel.launches == before + 1
    res = ptesting.compare_shade(got.cpu(), want.cpu())
    assert res["ok"], (res["same_frac"], res["max_abs_err"])


@pytest.mark.parametrize("half", [(True, True), (False, False)])
def test_composite_kernel_matches_twin(dev, half):
    ft = ptesting.random_frame_tables(11, N_TRIS, 32, WP, device=dev)
    tables, lights, eye, inv_vp = _shade_args(dev)
    o = FG.render_megakernel(ft, tables, lights, 0.45, eye, inv_vp, hp=32, wp=WP,
                             n_samples=4, use_mips=True)
    atlas = torch.as_tensor(ptesting.random_shade_inputs(5)["mip_flat"], device=dev)
    kw = dict(half0=half[0], half1=half[1], with_bloom=True)
    img, seed = CG.composite(o, atlas, **kw)
    img_t, seed_t = CG.composite_twin(o, atlas, **kw)
    torch.cuda.synchronize()
    assert (img - img_t).abs().max().item() <= 1e-6
    assert (seed - seed_t).abs().max().item() <= 1e-6


def test_wrappers_refuse_bad_inputs(dev):
    o = torch.zeros((2 * SG.O_CH, 32, 128), device=dev, dtype=torch.float64)
    atlas = torch.zeros((4, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        CG.composite(o, atlas, half0=True, half1=True, with_bloom=True)


def test_step_on_gpu_matches_cpu(dev):
    cfg = EngineConfig(width=256, height=128, enable_physics=False)
    cam = Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0), aspect=2.0)
    frames = {}
    for d in ("cpu", dev):
        # the texture of tests/test_torch_step.py: two texel columns keep
        # the quads' u seam (coplanar depth ties) out of the comparison
        model = ptesting.make_test_model(tex_hw=(16, 2), device=d)
        j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
        from reze_tpu_torch.anim import sampler

        base = torch.zeros((j, 4), device=d)
        base[:, 3] = 1.0
        breath = {"mask": torch.zeros(j, dtype=torch.bool, device=d),
                  "ranges": torch.zeros(j, device=d), "base": base,
                  "half_cycle": torch.tensor(2.0, device=d),
                  "start": torch.tensor(float("inf"), device=d)}
        step = make_step(model, cfg)
        state, frame = step(init_scene_state(model), torch.tensor(1 / 60, device=d),
                            cam.view_proj(d), cam.position(d), pipeline.make_lights(cfg, d),
                            sampler.empty_animation(j, nm, d), breath)
        frames[str(d)] = frame.cpu().numpy()
        assert state.diag.pair_overflow.item() == 0
    diff = np.abs(frames["cpu"] - frames[str(dev)]).max(-1)
    assert (diff <= 1 / 255).mean() >= 0.99
