"""The CUDA kernels against their plain torch twins on the card (the
composite in its nearest and quad modes), and the whole step on the GPU
against the step on the CPU, for the main path, the three other
megakernels (``rasterizer`` "stream", "mxu", "hybrid"), both per-pass
paths, the default configuration with physics and the parity config
(bilinear albedo through the quad composite, with and without physics);
each path's step free of synchronising copies; the rigid-body solver on
the card against its CPU run; the crowd's batched kernels (the hybrid's
too) against their twins at C = 3, and the frame and hybrid crowd kernels
on a character with no pair, on tiles fetched in one go beside tiles that
overflow into the two-stage ring, at C = 2 and at an odd C past the
card's resident blocks, and right after a 1080p launch; the hybrid crowd
render against each character's single render, and the crowd step on the
card against the crowd step on the CPU, against the single step of each
character, and free of synchronising copies; the solver's substeps
replayed from a CUDA graph against an eager loop of ``solver.substep`` on
the card, and on a second card while the first is current; the crowd over
two cards, a lane thread each from the first call, against the same
shards stepped in turn by one card's lane. Marked
``cuda``: every test skips without a CUDA device (the two-card tests
below two). Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``--noconftest``: the suite's conftest imports jax).

Every kernel but the composite does the same float and integer operations
as its twin: every output channel equal (``testing.bit_diff``; for the
raster pass also ``testing.compare_raster``). The composite is held to
1e-6 and a frame to 1/255 on 99 % of pixels, the CPU parity tests'
bounds. The solver's trajectories on the card and the CPU part in the
last bits (the two sum in other orders and round library functions
differently, and the card's scatter_add_ adds in no fixed order) and the
gap grows with frames: bodies within ``RIG_TOL`` =
1e-3 over the rig's first 10 frames and within ``SCENE_TOL`` = 1e-4 over
the contact scene's 60."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.camera import Camera
from reze_tpu_torch import bridge, distrib, tracing
from reze_tpu_torch.core.types import EngineConfig, init_physics_state, init_scene_state
from reze_tpu_torch.core.types import PhysicsModel as PT_PhysicsModel
from reze_tpu_torch.kernels import composite_gpu as CG
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import frame_hybrid as FH
from reze_tpu_torch.kernels import frame_mxu as FM
from reze_tpu_torch.kernels import frame_stream as FS
from reze_tpu_torch.kernels import raster_gpu as RG
from reze_tpu_torch.kernels import shade_gpu as SG
from reze_tpu_torch.physics import solver
from reze_tpu_torch.render import pipeline
from reze_tpu_torch.step import make_step

pytestmark = pytest.mark.cuda

HP, WP = 16, 256
N_TRIS = (400,) * 7
# dense tables: hundreds of pairs per tile in most passes, a few or none in
# others, segments of any length
DENSE = dict(n_tris=(1500, 900, 40, 700, 10, 1200, 300), hp=32, wp=512, pairs_per_tri=8.0)


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


@pytest.mark.parametrize("dense,analytic,use_mips,n", [
    (False, False, True, 4), (False, True, False, 1), (False, False, False, 2),
    (True, False, True, 4), (True, False, False, 4), (True, False, True, 3),
    (True, False, False, 1), (True, True, True, 1), (True, True, False, 1)])
def test_frame_kernel_matches_twin(dev, dense, analytic, use_mips, n):
    if dense:
        hp, wp = DENSE["hp"], DENSE["wp"]
        ft = ptesting.random_frame_tables(3, DENSE["n_tris"], hp, wp, device=dev,
                                          pairs_per_tri=DENSE["pairs_per_tri"])
        assert int(ft.overflow) == 0
        counts = ft.counts[ft.counts > 0]
        assert (counts % 32 != 0).any() and counts.max() > 2 * FG.CHUNK
        assert (ft.counts == 0).any()  # tiles empty in some passes
    else:
        hp, wp = HP, WP
        ft = ptesting.random_frame_tables(11, N_TRIS, hp, wp, device=dev)
    tables, lights, eye, inv_vp = _shade_args(dev)
    kw = dict(hp=hp, wp=wp, n_samples=n, use_mips=use_mips, lod_bias=(1.0, 0.0),
              analytic=analytic)
    before = FG.render_megakernel.launches
    got = FG.render_megakernel(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    want = FG.render_megakernel_twin(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    torch.cuda.synchronize()
    assert FG.render_megakernel.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)


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


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("half", [(False, False), (True, True), (False, True)])
def test_quad_composite_kernel_matches_twin(dev, half, crowd):
    """The quad mode (bilinear albedo from the seeded mip chain's quad
    table), one character or three: within 1e-6 of the twin, and counted
    as a quad launch."""
    seeds = CROWD_SEEDS if crowd else CROWD_SEEDS[:1]
    ft = ptesting.stack_tables([ptesting.random_frame_tables(s, N_TRIS, 32, WP, device=dev)
                                for s in seeds])
    tables, lights, eyes, ivps = _crowd_shade_args(dev)
    o = FG.render_megakernel_crowd(ft, tables, lights, 0.45, eyes[:len(seeds)],
                                   ivps[:len(seeds)], hp=32, wp=WP, n_samples=4, use_mips=True)
    quad = torch.as_tensor(ptesting.random_shade_inputs(5)["mip_quad"], device=dev)
    kw = dict(half0=half[0], half1=half[1], with_bloom=True)
    fn, twin = ((CG.composite_crowd, CG.composite_crowd_twin) if crowd
                else (CG.composite, CG.composite_twin))
    o = o if crowd else o[0].contiguous()
    before = (fn.launches, fn.quad_launches)
    img, seed = fn(o, quad, **kw)
    img_t, seed_t = twin(o, quad, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.quad_launches) == (before[0], before[1] + 1)
    assert (img - img_t).abs().max().item() <= 1e-6
    assert (seed - seed_t).abs().max().item() <= 1e-6


def test_quad_composite_refuses_unaligned_table(dev):
    """The quad mode reads each footprint as one 16-byte load: a table
    that does not start on a 16-byte boundary is refused."""
    o = torch.zeros((2 * SG.O_CH, 32, 128), device=dev)
    quad = torch.as_tensor(ptesting.random_shade_inputs(5)["mip_quad"], device=dev)
    buf = torch.zeros(quad.numel() + 4, dtype=torch.uint8, device=dev)
    shifted = buf[4:].view(quad.shape)
    shifted.copy_(quad)
    with pytest.raises(ValueError, match="16-byte"):
        CG.composite(o, shifted, half0=False, half1=False, with_bloom=True)
    with pytest.raises(ValueError):  # not contiguous
        CG.composite(o, quad.t().contiguous().t(), half0=False, half1=False, with_bloom=True)


def test_wrappers_refuse_bad_inputs(dev):
    o = torch.zeros((2 * SG.O_CH, 32, 128), device=dev, dtype=torch.float64)
    atlas = torch.zeros((4, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        CG.composite(o, atlas, half0=True, half1=True, with_bloom=True)


# (depth_write, with_attrs) of each chained pass
ALL_MODES = ((True, True), (True, False), (False, True), (False, False))


def _raster_chain(tabs, chain, zk, zt, bx):
    """Chain the passes through kernel and twin (each from its own depth
    buffer) and hold every pass's outputs to the twin's: within the CPU
    tests' bounds and, since kernel and twin do the same float operations,
    bit for bit in all nine channels and every depth."""
    for tb, (dw, attrs) in zip(tabs, chain):
        before = RG.raster_pass.launches
        zk, gk = RG.raster_pass(tb, zk, bx=bx, depth_write=dw, with_attrs=attrs)
        zt, gt = RG.raster_pass_twin(tb, zt, bx=bx, depth_write=dw, with_attrs=attrs)
        torch.cuda.synchronize()
        assert RG.raster_pass.launches == before + 1
        res = ptesting.compare_raster(zk, gk, zt, gt)
        assert res["ok"], res
        assert res["max_abs_err"] == 0.0, res
    return zk


@pytest.mark.parametrize("s,chain", [(4, ((True, True), (False, False))),
                                     (1, ((True, False), (False, True))),
                                     (2, ALL_MODES), (3, ALL_MODES)])
def test_raster_kernel_matches_twin(dev, s, chain):
    tabs = ptesting.random_raster_tables(11, (300,) * len(chain), 64, 256, device=dev)
    _raster_chain(tabs, chain, torch.ones((s, 64, 256), device=dev),
                  torch.ones((s, 64, 256), device=dev), 2)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_raster_kernel_dense_matches_twin(dev, s):
    """Hundreds of pairs per tile: several 128-pair chunks, every band
    touched, most pixels won many times."""
    tabs = ptesting.random_raster_tables(3, (1500, 1200), 64, 512, device=dev, cap=80000)
    for tb in tabs:
        assert int(tb.overflow) == 0
        assert tb.counts.min() > 0 and tb.counts.max() > 2 * 128
        assert (tb.counts % 128 != 0).all()
    _raster_chain(tabs, ((True, True), (False, True)), torch.ones((s, 64, 512), device=dev),
                  torch.ones((s, 64, 512), device=dev), 4)


@pytest.mark.parametrize("s", [1, 4])
def test_raster_kernel_keeps_untouched_depths(dev, s):
    """A few triangles over a seeded non-uniform depth buffer: tiles with
    no pair and 8-row bands that no pair of their tile touches keep their
    depths as they were, bit for bit, and write the fixed G-buffer."""
    hp, wp = 128, 512
    tabs = ptesting.random_raster_tables(4, (8, 8), hp, wp, device=dev)
    z0 = torch.as_tensor(np.random.default_rng(5).uniform(0.2, 1.0, (s, hp, wp)),
                         dtype=torch.float32, device=dev)
    by, bx = hp // RG.TILE_H, wp // RG.TILE_W
    touched = torch.zeros((by * bx, RG.BANDS), dtype=torch.bool, device=dev)
    for tb in tabs:
        touched |= ptesting.touched_bands(tb, wp)[0]
    counts = sum(tb.counts for tb in tabs)
    assert (counts == 0).any()  # empty tiles
    assert (~touched[counts > 0]).any() and touched.any()  # untouched bands of busy tiles
    zk = _raster_chain(tabs, ((True, True), (True, False)), z0.clone(), z0.clone(), bx)
    # (S, by, BANDS, 8, bx, 128) -> per (tile, band)
    keep = (~touched).reshape(by, bx, RG.BANDS).permute(0, 2, 1)[None, :, :, None, :, None]
    shape = (s, by, RG.BANDS, RG.BAND_H, bx, RG.TILE_W)
    kept = (zk.reshape(shape) == z0.reshape(shape)) | ~keep
    assert kept.all()


@pytest.mark.parametrize("bad", ["zbuf", "tab"])
def test_raster_wrapper_refuses_unaligned(dev, bad):
    tb = ptesting.random_raster_tables(11, (30,), 32, 128, device=dev)[0]
    z = torch.ones((4, 32, 128), device=dev)
    if bad == "zbuf":  # the kernel reads and writes depths as float4s
        z = torch.ones(z.numel() + 1, device=dev)[1:].view(4, 32, 128)
    else:  # the kernel copies rows in 16-byte units
        t = torch.zeros(tb.tab.numel() + 1, device=dev)[1:].view(tb.tab.shape)
        t.copy_(tb.tab)
        tb = tb._replace(tab=t)
    with pytest.raises(ValueError):
        RG.raster_pass(tb, z, bx=1, depth_write=True)


@pytest.mark.parametrize("empty_tiles", [((0, 0), (1, 1)), ()], ids=["some_empty", "all_present"])
@pytest.mark.parametrize("use_mips", [True, False])
def test_shade_stack_kernel_matches_twin(dev, use_mips, empty_tiles):
    stack = ptesting.random_stack(7, 64, 256, empty_tiles=empty_tiles, device=dev)
    tables, lights, eye, inv_vp = _shade_args(dev)
    kw = dict(use_mips=use_mips, lod_bias=(1.0, 0.0))
    before = SG.shade_stack.launches
    got = SG.shade_stack(stack, tables, lights, 0.45, eye, inv_vp, **kw)
    want = SG.shade_stack_twin(stack, tables, lights, 0.45, eye, inv_vp, **kw)
    torch.cuda.synchronize()
    assert SG.shade_stack.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)


def test_new_wrappers_refuse_bad_inputs(dev):
    tabs = ptesting.random_raster_tables(11, (30,), 32, 128, device=dev)[0]
    with pytest.raises(ValueError):  # 5 samples
        RG.raster_pass(tabs, torch.ones((5, 32, 128), device=dev), bx=1, depth_write=True)
    with pytest.raises(ValueError):  # not whole 32-row tiles
        RG.raster_pass(tabs, torch.ones((4, 16, 128), device=dev), bx=1, depth_write=True)
    tables, lights, eye, inv_vp = _shade_args(dev)
    with pytest.raises(ValueError):
        SG.shade_stack(torch.zeros((2 * SG.L_CH, 16, 128), device=dev), tables, lights,
                       0.45, eye, inv_vp)
    with pytest.raises(ValueError):  # not 16-byte aligned: the kernel reads float4s
        n = 2 * SG.L_CH * 32 * 128
        SG.shade_stack(torch.zeros(n + 1, device=dev)[1:].view(2 * SG.L_CH, 32, 128), tables,
                       lights, 0.45, eye, inv_vp)


@pytest.mark.parametrize("tabs,analytic,use_mips,n", [
    ("seeded", False, True, 4), ("seeded", True, False, 1), ("seeded", False, False, 2),
    ("seeded", False, True, 3), ("dense", False, True, 4), ("dense", True, False, 1),
    ("dense", False, False, 3), ("empty", False, True, 4), ("empty", True, True, 1)])
def test_hybrid_kernel_matches_twin(dev, tabs, analytic, use_mips, n):
    if tabs == "dense":
        hp, wp = DENSE["hp"], DENSE["wp"]
        ft = ptesting.random_frame_tables(3, DENSE["n_tris"], hp, wp, device=dev,
                                          pairs_per_tri=DENSE["pairs_per_tri"])
        assert int(ft.overflow) == 0 and ft.counts.max() > 2 * FH.CHUNK
    else:
        hp, wp = HP, WP
        ft = ptesting.random_frame_tables(11, N_TRIS, hp, wp, device=dev)
        if tabs == "empty":
            ft = ft._replace(counts=torch.zeros_like(ft.counts))
    tables, lights, eye, inv_vp = _shade_args(dev)
    kw = dict(hp=hp, wp=wp, n_samples=n, use_mips=use_mips, lod_bias=(1.0, 0.0),
              analytic=analytic)
    before = FH.render_megakernel_hybrid.launches
    got = FH.render_megakernel_hybrid(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    want = FH.render_megakernel_hybrid_twin(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    torch.cuda.synchronize()
    assert FH.render_megakernel_hybrid.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)


@pytest.mark.parametrize("n", [4, 2])
def test_mxu_kernel_matches_twin(dev, n):
    ft = ptesting.random_frame_tables(11, N_TRIS, HP, WP, device=dev)
    before = FM.render_megakernel_mxu.launches
    got = FM.render_megakernel_mxu(ft, hp=HP, wp=WP, n_samples=n)
    want = FM.render_megakernel_mxu_twin(ft, hp=HP, wp=WP, n_samples=n)
    torch.cuda.synchronize()
    assert FM.render_megakernel_mxu.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)


@pytest.mark.parametrize("n", [4, 1])
def test_stream_kernel_matches_twin(dev, n):
    st = ptesting.random_stream_tables(11, N_TRIS, HP, WP, device=dev)
    before = FS.render_megakernel_stream.launches
    got = FS.render_megakernel_stream(st, hp=HP, wp=WP, n_samples=n)
    want = FS.render_megakernel_stream_twin(st, hp=HP, wp=WP, n_samples=n)
    torch.cuda.synchronize()
    assert FS.render_megakernel_stream.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)
    stack = FS.compose_stream_state(got, n)
    assert torch.isfinite(stack).all()


def test_megakernel_wrappers_refuse_bad_inputs(dev):
    ft = ptesting.random_frame_tables(11, (30,) * 7, 16, 128, device=dev)
    with pytest.raises(ValueError):  # 5 samples
        FM.render_megakernel_mxu(ft, hp=16, wp=128, n_samples=5)
    with pytest.raises(ValueError):  # not whole 8x128 tiles
        FM.render_megakernel_mxu(ft, hp=12, wp=128, n_samples=4)
    tables, lights, eye, inv_vp = _shade_args(dev)
    with pytest.raises(ValueError):  # float64 rows
        FH.render_megakernel_hybrid(ft._replace(rows=ft.rows.double()), tables, lights, 0.45,
                                    eye, inv_vp, hp=16, wp=128, n_samples=4)
    n = ft.rows.numel()
    rows = torch.zeros(n + 1, device=dev)[1:].view(ft.rows.shape)
    for fn in (FG.render_megakernel, FH.render_megakernel_hybrid):
        with pytest.raises(ValueError):  # rows not 16-byte aligned: the kernels bulk-copy them
            fn(ft._replace(rows=rows), tables, lights, 0.45, eye, inv_vp, hp=16, wp=128,
               n_samples=4)
    st = ptesting.random_stream_tables(11, (30,) * 7, 16, 128, device=dev)
    with pytest.raises(ValueError):  # bounds of another frame
        FS.render_megakernel_stream(st, hp=32, wp=128, n_samples=4)


# the parity config: bench.py's parity_fps settings (bilinear albedo from
# the quad table, level 0, full res)
PARITY = {"albedo_bilinear": True, "albedo_mips": False, "albedo_half_visible": False,
          "albedo_half_occluded": False}
PATHS = {"main": {}, "stream": {"rasterizer": "stream"}, "mxu": {"rasterizer": "mxu"},
         "hybrid": {"rasterizer": "hybrid"}, "layered": {"use_megakernel": False},
         "per_pass": {"layered_shading": False}, "default": {"enable_physics": True},
         "parity": PARITY, "parity_default": {**PARITY, "enable_physics": True}}


def _step_args(model, cfg, d):
    """(dt, view_proj, eye, lights, track, breath) of a still pose."""
    from reze_tpu_torch.anim import sampler

    cam = Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                 aspect=cfg.width / cfg.height)
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    base = torch.zeros((j, 4), device=d)
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool, device=d),
              "ranges": torch.zeros(j, device=d), "base": base,
              "half_cycle": torch.tensor(2.0, device=d),
              "start": torch.tensor(float("inf"), device=d)}
    return (torch.tensor(1 / 60, device=d), cam.view_proj(d), cam.position(d),
            pipeline.make_lights(cfg, d), sampler.empty_animation(j, nm, d), breath)


def _path_cfg(name, **kw):
    """The path's EngineConfig: physics off but on the default path."""
    return EngineConfig(**{"enable_physics": False, **kw, **PATHS[name]})


@pytest.mark.parametrize("name", sorted(PATHS))
def test_step_on_gpu_matches_cpu(dev, name):
    cfg = _path_cfg(name, width=256, height=128)
    frames, states = {}, {}
    for d in ("cpu", dev):
        # the texture of tests/test_torch_step.py: two texel columns keep
        # the quads' u seam (coplanar depth ties) out of the comparison
        model = ptesting.make_test_model(tex_hw=(16, 2), device=d)
        args = _step_args(model, cfg, d)
        state, frame = make_step(model, cfg)(init_scene_state(model), *args)
        state, frame = make_step(model, cfg)(state, *args)
        frames[str(d)], states[str(d)] = frame.cpu().numpy(), state
        assert state.diag.pair_overflow.item() == 0
    diff = np.abs(frames["cpu"] - frames[str(dev)]).max(-1)
    assert (diff <= 1 / 255).mean() >= 0.99
    pc, pg = states["cpu"].physics, states[str(dev)].physics
    assert states["cpu"].diag.contact_overflow.item() == \
        states[str(dev)].diag.contact_overflow.item()
    assert pc.time_accum.item() == pg.time_accum.item()
    for a, b in ((pc.position, pg.position), (pc.quat, pg.quat)):
        assert (a - b.cpu()).abs().max().item() <= SCENE_TOL


@pytest.mark.parametrize("name", sorted(PATHS))
def test_step_makes_no_synchronising_copy(dev, name):
    """One 1080p step of each path under ``torch.cuda.set_sync_debug_mode``
    (after a first step, which fills the per-device constants): the
    physics-off paths wait for the stream nowhere, the paths with physics
    once, where the solver reads its substep count."""
    cfg = _path_cfg(name, width=1920, height=1080)
    model = ptesting.make_test_model(device=dev)
    step = make_step(model, cfg)
    args = _step_args(model, cfg, dev)
    state, _ = step(init_scene_state(model), *args)
    torch.cuda.set_sync_debug_mode("warn")  # its first call may itself warn
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, frame = step(state, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == (1 if PATHS[name].get("enable_physics") else 0), syncs
    assert bool(torch.isfinite(frame).all())


RIG_TOL = 1e-3
SCENE_TOL = 1e-4


def _contact_scene(d):
    """A dynamic sphere dropped onto a kinematic capsule rail along x,
    sliding with friction and bouncing with restitution, beside a pendulum
    on a spring joint -> (PhysicsModel, wq, wp) on ``d``."""
    n = 4
    q0 = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))
    rail = np.array([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32)
    pm = PT_PhysicsModel(
        bone_index=np.arange(n, dtype=np.int32), shape=np.array([2, 0, 0, 0], np.int32),
        size=np.array([[1.0, 40.0, 1.0], [0.5, 0, 0], [0.3, 0, 0], [0.4, 0, 0]], np.float32),
        mass=np.array([0, 1, 0, 1], np.float32), inv_mass=np.array([0, 1, 0, 1], np.float32),
        inv_inertia_local=np.full((n, 3), 10.0, np.float32),
        linear_damping=np.full(n, 0.1, np.float32), angular_damping=np.full(n, 0.1, np.float32),
        restitution=np.array([1.0, 0.6, 0, 0], np.float32),
        friction=np.array([1.0, 0.05, 0.5, 0.5], np.float32),
        is_dynamic=np.array([False, True, False, True]), no_contact=np.zeros(n, bool),
        group=np.zeros(n, np.int32), collision_mask=np.full(n, 0xFFFF, np.int32),
        body_offset_pos=np.zeros((n, 3), np.float32),
        body_offset_quat=np.stack([rail, q0[1], q0[2], q0[3]]),
        bind_pos=np.zeros((n, 3), np.float32), valid=np.ones(n, bool),
        joint_body_a=np.array([2], np.int32), joint_body_b=np.array([3], np.int32),
        joint_pos_a=np.array([[0, -1, 0]], np.float32), joint_quat_a=q0[:1],
        joint_pos_b=np.array([[0, 1, 0]], np.float32), joint_quat_b=q0[:1],
        joint_lin_min=np.zeros((1, 3), np.float32), joint_lin_max=np.zeros((1, 3), np.float32),
        joint_ang_min=np.full((1, 3), -1.0, np.float32),
        joint_ang_max=np.full((1, 3), 1.0, np.float32),
        joint_spring_lin=np.zeros((1, 3), np.float32),
        joint_spring_ang=np.full((1, 3), 5.0, np.float32),
        joint_valid=np.ones(1, bool), n_bodies=n, n_joints=1)
    wp = np.array([[0, 0, 0], [0, 3.5, 0], [6, 10, 0], [7, 8.5, 0]], np.float32)
    return (bridge.from_jax_arrays(pm, d), torch.as_tensor(q0, device=d),
            torch.as_tensor(wp, device=d))


@pytest.mark.parametrize("scene,frames,tol", [("rig", 10, RIG_TOL), ("contact", 60, SCENE_TOL)])
def test_solver_on_gpu_matches_cpu(dev, scene, frames, tol):
    traj = {}
    for d in ("cpu", dev):
        pm, wq, wp = (ptesting.make_physics_rig(0, device=d) if scene == "rig"
                      else _contact_scene(d))
        plan = solver.prepare(EngineConfig(), pm)
        st = init_physics_state(pm.bone_index.shape[0], d)
        out = []
        for f in range(frames):
            if f == 1 and scene == "contact":  # the sphere slides along the rail
                st = dataclasses.replace(st, lin_vel=st.lin_vel + torch.tensor(
                    [[0, 0, 0], [4.0, 0, 0], [0, 0, 0], [0, 0, 0]], device=d))
            bq, bp, st, ovf = solver.step(plan, st, torch.tensor(1 / 60, device=d), wq, wp)
            out.append((st.position.cpu(), st.quat.cpu(), bp.cpu(), ovf.item(),
                        st.time_accum.item()))
        traj[str(d)] = out
    for (pc, qc, bc, oc, ac), (pg, qg, bg, og, ag) in zip(traj["cpu"], traj[str(dev)]):
        assert (oc, ac) == (og, ag)
        for a, b in ((pc, pg), (qc, qg), (bc, bg)):
            assert torch.isfinite(b).all() and (a - b).abs().max().item() <= tol
    moved = (traj[str(dev)][-1][0] - traj[str(dev)][0][0]).abs().max().item()
    assert moved > 0.1


def _eager_substeps(plan, st, n_sub):
    """An eager loop of ``solver.substep`` from a placed state's bodies, a
    crowd's character keeping its state past its own count ``n_sub`` ->
    (pos, quat, lin_vel, ang_vel, overflow)."""
    carry = (st.position, st.quat, st.lin_vel, st.ang_vel,
             torch.zeros(n_sub.shape, dtype=torch.int64, device=n_sub.device))
    for i in range(int(n_sub.max())):
        live = i < n_sub
        carry = tuple(torch.where(live.view(live.shape + (1,) * (x.dim() - live.dim())), x, y)
                      for x, y in zip(solver.substep(plan, *carry), carry))
    return carry


# per case: the crowd size (0: the rig alone), then per call each
# character's time accumulator and the frame time, in substeps
GRAPH_CASES = ((0, (((0.25,), 1.0), ((0.25,), 2.0), ((0.25,), 1.0))),
               (3, (((0.1, 0.7, 0.3), 1.5), ((0.1, 0.7, 0.9), 0.5))),
               (2, (((0.6, 0.2), 1.6),)))


def _check_graph_replays(dev):
    """``solver.step`` on ``dev`` against :func:`_eager_substeps` on ``dev``
    over ``GRAPH_CASES``, bit for bit, with the counters and no aliasing."""
    pm, wq, wp = ptesting.make_physics_rig(0, device=dev)
    plan = solver.prepare(EngineConfig(), pm)
    one = init_physics_state(pm.bone_index.shape[0], dev)
    kept = []
    tracing.reset()
    was = tracing.enable(True)
    try:
        for c, calls in GRAPH_CASES:
            lead = (c,) if c else ()
            st = type(one)(**{k: v.expand(lead + v.shape).clone()
                              for k, v in dataclasses.asdict(one).items()})
            q = wq.expand(lead + wq.shape)
            p = wp + 0.05 * torch.arange(max(c, 1), device=dev).view(lead + (1, 1))
            _, _, st, _ = solver.step(plan, st, torch.zeros((), device=dev), q, p)  # placed
            for k, (accum, dt) in enumerate(calls):
                st = dataclasses.replace(st, time_accum=torch.tensor(accum, device=dev).view(lead)
                                         * plan.h)
                dt = dt * plan.h
                n_sub = torch.floor((st.time_accum + dt) / plan.h).to(torch.int32)
                want = _eager_substeps(plan, st, n_sub)
                before = tracing.counters()
                _, _, st, ovf = solver.step(plan, st, dt, q, p)
                got = (st.position, st.quat, st.lin_vel, st.ang_vel, ovf)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (c, k, (a.double() - b.double()).abs().max().item())
                grew = {name: tracing.counters().get(name, 0) - before.get(name, 0)
                        for name in ("physics.substeps", "physics.graph_captures",
                                     "physics.graph_replays")}
                n_run = int(n_sub.max())
                assert grew == {"physics.substeps": n_run, "physics.graph_captures": int(k == 0),
                                "physics.graph_replays": n_run - int(k == 0)}, (c, k, grew)
                for old, copy in kept:
                    assert all(torch.equal(x, y) for x, y in zip(old, copy))
                kept.append((got, tuple(x.clone() for x in got)))
                assert c != 3 or k or len(set(n_sub.tolist())) > 1
    finally:
        tracing.enable(was)
        tracing.reset()
    assert len(plan.graphs) == 3


def test_solver_graph_replays_the_eager_substeps(dev):
    """``solver.step`` on the card (its substeps replayed from one CUDA graph
    per leading shape) against an eager loop of ``solver.substep`` on the
    card from the same state: the rig alone at one and two substeps, a
    crowd of 3 whose characters run different counts, and a crowd of 2 on
    the same plan (a second graph). Every state a call returned is
    unchanged after the later calls, and only a leading shape's first call
    captures."""
    _check_graph_replays(dev)


# --- the crowd: batched kernels and the crowd step ----------------------------

CROWD_SEEDS = (11, 12, 13)


def _crowd_shade_args(dev):
    """The shared shade tables and lights, and per character a seeded eye
    position (C, 3) and inverse view-projection (C, 4, 4)."""
    tables, lights, _, _ = _shade_args(dev)
    sh = [ptesting.random_shade_inputs(s) for s in CROWD_SEEDS]
    return (tables, lights, torch.as_tensor(np.stack([x["eye_pos"] for x in sh]), device=dev),
            torch.as_tensor(np.stack([x["inv_vp"] for x in sh]), device=dev))


def _crowd_frame_tables(dev, n_tris=N_TRIS):
    return ptesting.stack_tables([ptesting.random_frame_tables(s, n_tris, HP, WP, device=dev)
                                  for s in CROWD_SEEDS])


@pytest.mark.parametrize("analytic,use_mips,n", [(False, True, 4), (True, False, 1),
                                                 (False, False, 2)])
def test_frame_crowd_kernel_matches_twin(dev, analytic, use_mips, n):
    """One launch over three characters: bit for bit the crowd twin, and
    each character's output that of the single-character launch."""
    ft = _crowd_frame_tables(dev)
    tables, lights, eyes, ivps = _crowd_shade_args(dev)
    kw = dict(hp=HP, wp=WP, n_samples=n, use_mips=use_mips, lod_bias=(1.0, 0.0),
              analytic=analytic)
    before = FG.render_megakernel_crowd.launches
    got = FG.render_megakernel_crowd(ft, tables, lights, 0.45, eyes, ivps, **kw)
    want = FG.render_megakernel_crowd_twin(ft, tables, lights, 0.45, eyes, ivps, **kw)
    torch.cuda.synchronize()
    assert FG.render_megakernel_crowd.launches == before + 1
    assert got.shape == (len(CROWD_SEEDS), 2 * SG.O_CH, HP, WP)
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)
    for c in range(len(CROWD_SEEDS)):
        one = FG.FrameTables(ft.rows[c], ft.starts[c], ft.counts[c], ft.overflow[c])
        assert torch.equal(got[c], FG.render_megakernel(one, tables, lights, 0.45, eyes[c],
                                                        ivps[c], **kw))


@pytest.mark.parametrize("n", [4, 1])
def test_stream_crowd_kernel_matches_twin(dev, n):
    st = ptesting.stack_tables([ptesting.random_stream_tables(s, N_TRIS, HP, WP, device=dev)
                                for s in CROWD_SEEDS])
    before = FS.render_megakernel_stream_crowd.launches
    got = FS.render_megakernel_stream_crowd(st, hp=HP, wp=WP, n_samples=n)
    want = FS.render_megakernel_stream_crowd_twin(st, hp=HP, wp=WP, n_samples=n)
    torch.cuda.synchronize()
    assert FS.render_megakernel_stream_crowd.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)
    stack = FS.compose_stream_state(got, n)
    assert stack.shape == (len(CROWD_SEEDS), 2 * SG.L_CH, HP, WP)
    assert torch.equal(stack[1], FS.compose_stream_state(got[1], n))


@pytest.mark.parametrize("use_mips", [True, False])
def test_shade_stack_crowd_kernel_matches_twin(dev, use_mips):
    stack = torch.stack([ptesting.random_stack(s, 64, 256, empty_tiles=((0, 0),), device=dev)
                         for s in CROWD_SEEDS])
    tables, lights, eyes, ivps = _crowd_shade_args(dev)
    kw = dict(use_mips=use_mips, lod_bias=(1.0, 0.0))
    before = SG.shade_stack_crowd.launches
    got = SG.shade_stack_crowd(stack, tables, lights, 0.45, eyes, ivps, **kw)
    want = SG.shade_stack_crowd_twin(stack, tables, lights, 0.45, eyes, ivps, **kw)
    torch.cuda.synchronize()
    assert SG.shade_stack_crowd.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)


@pytest.mark.parametrize("half", [(True, True), (False, True)])
def test_composite_crowd_kernel_matches_twin(dev, half):
    ft = ptesting.stack_tables([ptesting.random_frame_tables(s, N_TRIS, 32, WP, device=dev)
                                for s in CROWD_SEEDS])
    tables, lights, eyes, ivps = _crowd_shade_args(dev)
    o = FG.render_megakernel_crowd(ft, tables, lights, 0.45, eyes, ivps, hp=32, wp=WP,
                                   n_samples=4, use_mips=True)
    atlas = torch.as_tensor(ptesting.random_shade_inputs(5)["mip_flat"], device=dev)
    kw = dict(half0=half[0], half1=half[1], with_bloom=True)
    before = CG.composite_crowd.launches
    img, seed = CG.composite_crowd(o, atlas, **kw)
    img_t, seed_t = CG.composite_crowd_twin(o, atlas, **kw)
    torch.cuda.synchronize()
    assert CG.composite_crowd.launches == before + 1
    assert (img - img_t).abs().max().item() <= 1e-6
    assert (seed - seed_t).abs().max().item() <= 1e-6


@pytest.mark.parametrize("analytic,use_mips,n", [(False, True, 4), (True, False, 1),
                                                 (False, False, 2)])
def test_hybrid_crowd_kernel_matches_twin(dev, analytic, use_mips, n):
    """One launch of the hybrid kernel over three characters: bit for bit
    the crowd twin, and each character's output that of the
    single-character launch."""
    ft = _crowd_frame_tables(dev)
    tables, lights, eyes, ivps = _crowd_shade_args(dev)
    kw = dict(hp=HP, wp=WP, n_samples=n, use_mips=use_mips, lod_bias=(1.0, 0.0),
              analytic=analytic)
    before = FH.render_megakernel_hybrid_crowd.launches
    got = FH.render_megakernel_hybrid_crowd(ft, tables, lights, 0.45, eyes, ivps, **kw)
    want = FH.render_megakernel_hybrid_crowd_twin(ft, tables, lights, 0.45, eyes, ivps, **kw)
    torch.cuda.synchronize()
    assert FH.render_megakernel_hybrid_crowd.launches == before + 1
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)
    for c in range(len(CROWD_SEEDS)):
        one = FG.FrameTables(ft.rows[c], ft.starts[c], ft.counts[c], ft.overflow[c])
        assert torch.equal(got[c], FH.render_megakernel_hybrid(one, tables, lights, 0.45,
                                                               eyes[c], ivps[c], **kw))


# the crowd launches of the frame and hybrid kernels on what the tile
# design (csrc/frame_common.cuh run_tile) tells apart: tiles fetched in one
# go or through the ring, empty tiles and characters, many characters;
# each case in every sample count and in analytic mode, both kernels
CROWD_MODES = [(1, False), (2, False), (3, False), (4, False), (1, True)]
CROWD_KERNELS = {"frame": (FG.render_megakernel_crowd, FG.render_megakernel_crowd_twin),
                 "hybrid": (FH.render_megakernel_hybrid_crowd,
                            FH.render_megakernel_hybrid_crowd_twin)}
SPARSE_TRIS, FULL_TRIS = (40,) * 7, (400,) * 7


def _padded_crowd(tabs):
    """Per-character tables of any row count -> the crowd's, each
    character's rows padded with zero rows to the longest (rows past a
    character's segments are never read)."""
    n = max(t.rows.shape[0] for t in tabs)
    return ptesting.stack_tables([t._replace(rows=torch.cat(
        [t.rows, t.rows.new_zeros((n - t.rows.shape[0], FG.ROW_W))])) for t in tabs])


def _check_crowd_kernel(dev, kernel, ft, n, analytic, hp=HP, wp=WP):
    """One crowd launch of ``kernel`` on ``ft``, each character with its
    own eye position and inverse view-projection: bit for bit its twin."""
    tables, lights, eye, inv_vp = _shade_args(dev)
    c = ft.rows.shape[0]
    eyes = eye + 0.05 * torch.arange(c, device=dev, dtype=torch.float32)[:, None]
    ivps = inv_vp * (1.0 + 0.01 * torch.arange(c, device=dev, dtype=torch.float32))[:, None, None]
    kw = dict(hp=hp, wp=wp, n_samples=n, use_mips=not analytic, lod_bias=(1.0, 0.0),
              analytic=analytic)
    fn, twin = CROWD_KERNELS[kernel]
    before = fn.launches
    got = fn(ft, tables, lights, 0.45, eyes, ivps, **kw)
    want = twin(ft, tables, lights, 0.45, eyes, ivps, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (c, 2 * SG.O_CH, hp, wp)
    assert ptesting.bit_diff(got, want) == (1.0, 0.0)


@pytest.mark.parametrize("n,analytic", CROWD_MODES)
@pytest.mark.parametrize("kernel", sorted(CROWD_KERNELS))
def test_crowd_kernel_with_an_empty_character(dev, kernel, n, analytic):
    """A crowd in which the middle character has no pair in any tile: its
    tiles write the fixed empty output between the others' tiles."""
    ft = ptesting.stack_tables([ptesting.random_frame_tables(s, SPARSE_TRIS, HP, WP, device=dev)
                                for s in CROWD_SEEDS])
    ft = ft._replace(counts=ft.counts.clone())
    ft.counts[1] = 0
    _check_crowd_kernel(dev, kernel, ft, n, analytic)


@pytest.mark.parametrize("n,analytic", CROWD_MODES)
@pytest.mark.parametrize("kernel", sorted(CROWD_KERNELS))
def test_crowd_kernel_fetch_overflow(dev, kernel, n, analytic):
    """Characters whose tiles fit one ring stage (fetched in one go) beside
    ones whose pairs overflow it into the two-stage ring, some passes
    longer than a chunk: a block alternates between both walks."""
    ft = _padded_crowd([ptesting.random_frame_tables(s, tris, HP, WP, device=dev)
                        for s, tris in zip(CROWD_SEEDS, (SPARSE_TRIS, FULL_TRIS, SPARSE_TRIS))])
    totals = ft.counts.sum(1)
    assert (totals <= FG.CHUNK).any() and (totals > FG.CHUNK).any()
    assert ft.counts.max() > FG.CHUNK
    _check_crowd_kernel(dev, kernel, ft, n, analytic)


@pytest.mark.parametrize("n,analytic", CROWD_MODES)
@pytest.mark.parametrize("kernel", sorted(CROWD_KERNELS))
@pytest.mark.parametrize("chars", ["two", "past_the_grid"])
def test_crowd_kernel_character_counts(dev, kernel, n, analytic, chars):
    """C = 2, and an odd C whose C x tiles exceed the blocks the card holds
    at once (two per SM), so that the blocks of many characters run in
    turns."""
    tiles = (HP // FG.TILE_H) * (WP // FG.TILE_W)
    if chars == "two":
        c = 2
    else:
        c = 2 * torch.cuda.get_device_properties(dev).multi_processor_count // tiles + 1
        c += 1 - c % 2
        assert c * tiles > 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    ft = _padded_crowd([ptesting.random_frame_tables(100 + i, SPARSE_TRIS if i % 3 else FULL_TRIS,
                                                     HP, WP, device=dev) for i in range(c)])
    _check_crowd_kernel(dev, kernel, ft, n, analytic)


@pytest.mark.parametrize("n,analytic", CROWD_MODES)
@pytest.mark.parametrize("kernel", sorted(CROWD_KERNELS))
def test_crowd_kernel_after_a_single_launch(dev, kernel, n, analytic):
    """A crowd launched right after a 1088x1920 single-character launch of
    the same kernel: nothing of that launch reaches the crowd's output."""
    tables, lights, eye, inv_vp = _shade_args(dev)
    big = ptesting.random_frame_tables(7, N_TRIS, 1088, 1920, device=dev)
    single = {"frame": FG.render_megakernel, "hybrid": FH.render_megakernel_hybrid}[kernel]
    single(big, tables, lights, 0.45, eye, inv_vp, hp=1088, wp=1920, n_samples=n,
           use_mips=not analytic, analytic=analytic)
    ft = _padded_crowd([ptesting.random_frame_tables(s, tris, HP, WP, device=dev)
                        for s, tris in zip(CROWD_SEEDS, (FULL_TRIS, SPARSE_TRIS, SPARSE_TRIS))])
    _check_crowd_kernel(dev, kernel, ft, n, analytic)


def test_hybrid_crowd_matches_single_renders(dev):
    """``render_crowd_mega`` with ``rasterizer="hybrid"`` on three
    characters of the synthetic model, each with its own pose jitter and
    camera: each frame equal to that character's ``render_frame_mega``."""
    from reze_tpu_torch.render import pipeline_gpu

    cfg = EngineConfig(width=256, height=128, enable_physics=False, rasterizer="hybrid")
    model = ptesting.make_test_model(device=dev)
    dims = pipeline_gpu.make_dims_fast(cfg)
    _, vps, eyes, lights, _, _ = _crowd_args(model, cfg, 3, dev)
    pos0 = model.geometry.positions
    gen = torch.Generator(device="cpu").manual_seed(4)
    pos = torch.stack([pos0 + 0.02 * torch.randn(pos0.shape, generator=gen).to(dev)
                       for _ in range(3)])
    nrm = model.geometry.normals.expand((3,) + model.geometry.normals.shape).contiguous()
    before = FH.render_megakernel_hybrid_crowd.launches
    frames, ovf = pipeline_gpu.render_crowd_mega(model, cfg, dims, pos, nrm, vps, eyes, lights)
    assert FH.render_megakernel_hybrid_crowd.launches == before + 1
    for c in range(3):
        f1, o1 = pipeline_gpu.render_frame_mega(model, cfg, dims, pos[c], nrm[c], vps[c],
                                                eyes[c], lights)
        assert torch.equal(frames[c], f1), c
        assert int(ovf[c]) == int(o1) == 0
        assert (f1.sum(-1) > 0.01).float().mean() > 0.05


def test_crowd_wrapper_refuses_unaligned_character(dev):
    """The frame kernel bulk-copies each character's rows: rows whose
    per-character stride leaves a character's block off a 16-byte
    boundary are refused, though the base pointer is aligned; a stride
    that keeps every block aligned launches, and gives the contiguous
    crowd's output."""
    ft = _crowd_frame_tables(dev)
    tables, lights, eyes, ivps = _crowd_shade_args(dev)
    c, n, w = ft.rows.shape
    kw = dict(hp=HP, wp=WP, n_samples=4)
    want = FG.render_megakernel_crowd(ft, tables, lights, 0.45, eyes, ivps, **kw)
    for pad, ok in ((1, False), (4, True)):
        buf = torch.zeros(c * (n * w + pad), device=dev)
        rows = torch.as_strided(buf, (c, n, w), (n * w + pad, w, 1))
        rows.copy_(ft.rows)
        args = (ft._replace(rows=rows), tables, lights, 0.45, eyes, ivps)
        if ok:
            assert torch.equal(FG.render_megakernel_crowd(*args, **kw), want)
        else:
            with pytest.raises(ValueError, match="16-byte"):
                FG.render_megakernel_crowd(*args, **kw)
    with pytest.raises(ValueError):  # one eye position for three characters
        FG.render_megakernel_crowd(ft, tables, lights, 0.45, eyes[0], ivps, **kw)


def _crowd_args(model, cfg, n, d):
    """(dt, view_projs, eyes, lights, track, breath) of ``n`` characters,
    each with its own camera; a seeded clip shared by the crowd."""
    _, _, _, lights, _, breath = _step_args(model, cfg, d)
    cams = [Camera(alpha=0.2 * c - 0.3, beta=np.pi / 2, radius=3.4 + 0.2 * c,
                   target=(0.0, 1.9, 0.0), aspect=cfg.width / cfg.height) for c in range(n)]
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    return (torch.tensor(1 / 60, device=d), torch.stack([cam.view_proj(d) for cam in cams]),
            torch.stack([cam.position(d) for cam in cams]), lights,
            ptesting.make_test_track(1, j, nm, device=d), breath)


def _crowd_states(model, n):
    states = distrib.batch_state(model, n)
    dev = states.time.device
    return dataclasses.replace(states, playing=torch.ones(n, dtype=torch.bool, device=dev),
                               play_t0=-0.35 * torch.arange(n, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("rasterizer", ["group", "stream"])
def test_crowd_step_on_gpu_matches_cpu(dev, rasterizer):
    cfg = EngineConfig(width=256, height=128, rasterizer=rasterizer)
    frames, states = {}, {}
    for d in ("cpu", dev):
        model = ptesting.make_test_model(tex_hw=(16, 2), device=d)
        step = distrib.make_batched_step(model, cfg)
        args = _crowd_args(model, cfg, 3, d)
        state, frame = step(_crowd_states(model, 3), *args)
        state, frame = step(state, *args)
        frames[str(d)], states[str(d)] = frame.cpu().numpy(), state
        assert (state.diag.pair_overflow == 0).all()
    for c in range(3):
        diff = np.abs(frames["cpu"][c] - frames[str(dev)][c]).max(-1)
        assert (diff <= 1 / 255).mean() >= 0.99, c
    pc, pg = states["cpu"].physics, states[str(dev)].physics
    assert torch.equal(pc.time_accum, pg.time_accum.cpu())
    assert (pc.position - pg.position.cpu()).abs().max().item() <= SCENE_TOL


@pytest.mark.parametrize("rasterizer", ["group", "stream"])
def test_crowd_step_on_gpu_matches_single_steps(dev, rasterizer):
    """A crowd of three (not a power of two) on the card: each character's
    frame within 1e-5 of the single step from its own state."""
    cfg = EngineConfig(width=256, height=128, rasterizer=rasterizer)
    model = ptesting.make_test_model(tex_hw=(16, 2), device=dev)
    step, single = distrib.make_batched_step(model, cfg), make_step(model, cfg)
    dt, vps, eyes, lights, track, breath = _crowd_args(model, cfg, 3, dev)
    before, _ = step(_crowd_states(model, 3), dt, vps, eyes, lights, track, breath)
    _, frames = step(before, dt, vps, eyes, lights, track, breath)
    for c in range(3):
        _, f1 = single(distrib._map(lambda x: x[c], before), dt, vps[c], eyes[c], lights,
                       track, breath)
        assert (f1 - frames[c]).abs().max().item() <= 1e-5, c


@pytest.mark.parametrize("rasterizer", ["group", "stream"])
@pytest.mark.parametrize("physics", [False, True])
def test_crowd_step_makes_no_synchronising_copy(dev, rasterizer, physics):
    """One crowd step of four characters under ``set_sync_debug_mode``
    (after a first step): no synchronising copy with physics off, one with
    physics on, where the solver reads the crowd's largest substep count."""
    cfg = EngineConfig(width=256, height=256, rasterizer=rasterizer, enable_physics=physics)
    model = ptesting.make_test_model(device=dev)
    step = distrib.make_batched_step(model, cfg)
    args = _crowd_args(model, cfg, 4, dev)
    state, _ = step(_crowd_states(model, 4), *args)
    torch.cuda.set_sync_debug_mode("warn")  # its first call may itself warn
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, frames = step(state, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == (1 if physics else 0), syncs
    assert bool(torch.isfinite(frames).all())


def test_kernels_launch_on_their_tensors_card(dev):
    """The frame and composite kernels on ``cuda:1`` while ``cuda:0`` is
    current: each wrapper makes its tensors' device current for the
    launch, and the frame kernel's shared-memory attribute is set for that
    device's context (the first launch there asks for more than 48 KB)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices; "
                    f"{torch.cuda.device_count()} visible")
    second = torch.device("cuda", 1)
    ft = ptesting.random_frame_tables(11, N_TRIS, 32, WP, device=second)
    tables, lights, eye, inv_vp = _shade_args(second)
    atlas = torch.as_tensor(ptesting.random_shade_inputs(5)["mip_flat"], device=second)
    kw = dict(hp=32, wp=WP, n_samples=4, use_mips=True)
    ckw = dict(half0=True, half1=True, with_bloom=True)
    with torch.cuda.device(0):
        o = FG.render_megakernel(ft, tables, lights, 0.45, eye, inv_vp, **kw)
        img, seed = CG.composite(o, atlas, **ckw)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(second)
    assert o.device == img.device == second
    o_t = FG.render_megakernel_twin(ft, tables, lights, 0.45, eye, inv_vp, **kw)
    assert ptesting.bit_diff(o, o_t) == (1.0, 0.0)
    img_t, seed_t = CG.composite_twin(o_t, atlas, **ckw)
    assert (img - img_t).abs().max().item() <= 1e-6
    assert (seed - seed_t).abs().max().item() <= 1e-6


def test_solver_graph_replays_on_its_tensors_card(dev):
    """The solver's graphs on ``cuda:1`` while ``cuda:0`` is current: the
    eager first substep, the capture and every replay run on the carry's
    card, and match an eager loop of ``solver.substep`` there bit for bit
    (a capture on the current card's stream would record nothing of it)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices; "
                    f"{torch.cuda.device_count()} visible")
    with torch.cuda.device(0):
        _check_graph_replays(torch.device("cuda", 1))
        assert torch.cuda.current_device() == 0


def test_sharded_crowd_steps_cards_side_by_side(dev):
    """Four characters over two cards, each card's lane on its own thread
    from the first call, so that one card captures its solver graph while
    the other lane waits on its own card: states and frames equal bit for
    bit, over 8 steps, those of the same two shards stepped in turn by one
    card's lane (``make_mesh(devices=[cuda:0] * 2)``). The first step
    captures one graph a lane; every later substep is a replay."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices; "
                    f"{torch.cuda.device_count()} visible")
    cfg = EngineConfig(width=128, height=128)
    model = ptesting.make_test_model(tex_hw=(16, 2), device=dev)
    dt, vps, eyes, lights, track, breath = _crowd_args(model, cfg, 4, dev)
    first = torch.device("cuda", 0)
    runs = {}
    tracing.reset()
    was = tracing.enable(True)
    try:
        for name, mesh in (("two_cards", distrib.make_mesh(2)),
                           ("one_card", distrib.make_mesh(devices=[first] * 2))):
            step = distrib.make_batched_step(model, cfg, mesh=mesh)
            sh = lambda x: distrib.shard_batch(x, mesh)  # noqa: E731
            shared = [distrib.replicate(x, mesh) for x in (dt, lights, track, breath)]
            states, shards = sh(_crowd_states(model, 4)), (sh(vps), sh(eyes))
            lanes = len(set(mesh.devices))
            runs[name] = []
            for k in range(8):
                before = tracing.counters()
                states, frames = step(states, shared[0], *shards, *shared[1:])
                grew = {c: tracing.counters().get(c, 0) - before.get(c, 0)
                        for c in ("physics.substeps", "physics.graph_captures",
                                  "physics.graph_replays", "crowd.shards")}
                assert grew["crowd.shards"] == 2, (name, k, grew)
                captures = lanes if k == 0 else 0
                assert grew["physics.graph_captures"] == captures, (name, k, grew)
                assert grew["physics.graph_replays"] == grew["physics.substeps"] - captures
                runs[name].append((distrib.gather(states, first), distrib.gather(frames, first)))
    finally:
        tracing.enable(was)
        tracing.reset()
    for k, ((s2, f2), (s1, f1)) in enumerate(zip(runs["two_cards"], runs["one_card"])):
        assert torch.equal(f2, f1), k
        flat2, flat1 = [], []
        distrib._map(flat2.append, s2)
        distrib._map(flat1.append, s1)
        assert all(torch.equal(a, b) or bool(((a == b) | (a.isnan() & b.isnan())).all())
                   for a, b in zip(flat2, flat1)), k
    assert runs["two_cards"][-1][1].abs().sum() > 0
