"""The port's whole step against the JAX package's ``make_step`` with
``renderer="tpu"`` (the Pallas kernels in interpret mode: the path the
engine runs, not the XLA oracle) on the synthetic model at 128x64 with the
default ``enable_physics=True`` (two bodies, one spring joint), for three
frames; the second frame sets a morph weight and starts a bone tween.

Bounds: frames within 1/255 on >= 99 % of pixels; ``time``,
``pair_overflow``, ``contact_overflow``, the physics accumulator and its
``initialized`` flag exact; body positions and quaternions within 1e-5.

The model's texture is 16x2 texels. Its quads map u to 0 along each quad's
diagonal from both sides, and a pixel on that seam takes its texel from
whichever of the two coplanar triangles wins a depth comparison that the
last bit of their plane constants decides. XLA compiles the JAX side with
fused multiply-adds and the port rounds each product, so the two resolve
those ties differently, and with the default 8x8 texture the seam then
shows as a line of wrapped texels. Two texel columns keep the seam's
colour out of the comparison; the v direction and the mip chain still
sample a gradient.
"""

import dataclasses
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import camera as jcam
from reze_tpu import testing as jtesting
from reze_tpu.anim import sampler as jsampler
from reze_tpu.anim import tween as jtween
from reze_tpu.core import types as JT
from reze_tpu.render import pipeline as jpipe
from reze_tpu.step import make_step as jmake_step
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.anim import tween as ptween
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.render import pipeline_gpu
from reze_tpu_torch.step import make_step as pmake_step
from test_torch_frame import _one_thread  # noqa: F401

W, H = 128, 64
TEX_HW = (16, 2)
N_FRAMES = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tween_args(j):
    mask = np.zeros(j, bool)
    mask[2] = True
    targets = np.zeros((j, 4), np.float32)
    targets[:, 3] = 1.0
    targets[2] = (0.0, 0.0, np.sin(0.2), np.cos(0.2))  # 0.4 rad about z
    return mask, targets


def run_frames(**cfg_kw):
    """Both packages' ``make_step`` for N_FRAMES frames with the same
    EngineConfig changes -> per frame the JAX and port frames and states.
    The second frame sets a morph weight and starts a bone tween."""
    jmodel = jtesting.make_test_model(tex_hw=TEX_HW)
    pmodel = ptesting.make_test_model(tex_hw=TEX_HW, device="cpu")
    jcfg = JT.EngineConfig(width=W, height=H, renderer="tpu", **cfg_kw)
    pcfg = PT.EngineConfig(width=W, height=H, **cfg_kw)
    cam = jcam.Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                      aspect=W / H)
    vp, eye = np.array(cam.view_proj()), np.array(cam.position())
    j, nm = jmodel.skeleton.j, jmodel.morphs.offsets.shape[0]
    track = jax.device_get(jsampler.empty_animation(j, nm))
    breath = {"mask": np.zeros(j, bool), "ranges": np.zeros(j, np.float32),
              "base": np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1)),
              "half_cycle": np.float32(2.0), "start": np.float32(np.inf)}
    jlights = jpipe.make_lights(jcfg)
    jargs = (jnp.asarray(vp), jnp.asarray(eye), jlights, jax.device_put(track),
             jax.device_put(breath))
    pargs = (torch.as_tensor(vp), torch.as_tensor(eye),
             bridge.from_jax_arrays(jax.device_get(jlights), "cpu"),
             bridge.from_jax_arrays(track, "cpu"), bridge.from_jax_arrays(breath, "cpu"))
    jstep = jax.jit(jmake_step(jmodel, jcfg))
    pstep = pmake_step(pmodel, pcfg)
    js, ps = JT.init_scene_state(jmodel), PT.init_scene_state(pmodel)
    out = []
    for f in range(N_FRAMES):
        if f == 1:
            mask, targets = _tween_args(j)
            jtw, jrot = jtween.start_tweens(js.tween, js.local_rot, js.time,
                                            jnp.asarray(mask), jnp.asarray(targets),
                                            jnp.float32(0.05))
            js = js.replace(tween=jtw, local_rot=jrot,
                            morph_weights=jnp.asarray([0.8, 0.0]))
            ptw, prot = ptween.start_tweens(ps.tween, ps.local_rot, ps.time,
                                            torch.as_tensor(mask), torch.as_tensor(targets),
                                            torch.tensor(0.05))
            ps = dataclasses.replace(ps, tween=ptw, local_rot=prot,
                                     morph_weights=torch.tensor([0.8, 0.0]))
        js, jf = jstep(js, jnp.float32(1 / 60), *jargs)
        ps, pf = pstep(ps, torch.tensor(1 / 60), *pargs)
        out.append(dict(jframe=np.asarray(jf), pframe=pf.numpy(),
                        jstate=jax.device_get(js), pstate=ps))
    return out


def bind_pose(jmodel):
    """Skinned vertex positions and normals of the JAX model in its bind
    pose, as numpy."""
    from reze_tpu.kernels.skinning import skin_vertices
    from reze_tpu.skeleton import fk as jfk

    skel = jmodel.skeleton
    rot = jnp.zeros((skel.j, 4)).at[:, 3].set(1.0)
    q, p = jfk.world_transforms(skel, rot, jnp.zeros((skel.j, 3)))
    pos, nrm = skin_vertices(jmodel.geometry, jmodel.skinning, jfk.skin_palette(skel, q, p))
    return np.array(pos), np.array(nrm)


def mega_frames(rasterizer, width=256, height=64):
    """``render_frame_mega`` of both packages on the synthetic model in its
    bind pose with ``rasterizer`` and default settings otherwise (4x MSAA,
    mips, half-res albedo, bloom) -> (JAX frame, JAX pair overflow, port
    frame, port pair overflow). The JAX side runs its Pallas kernels in
    interpret mode."""
    from reze_tpu.render import pipeline_tpu
    from reze_tpu.render import shading_fast as JSF

    jmodel = jtesting.make_test_model(tex_hw=TEX_HW)
    pmodel = ptesting.make_test_model(tex_hw=TEX_HW, device="cpu")
    kw = dict(width=width, height=height, enable_physics=False, rasterizer=rasterizer)
    jcfg, pcfg = JT.EngineConfig(renderer="tpu", **kw), PT.EngineConfig(**kw)
    cam = jcam.Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                      aspect=width / height)
    vp, eye = np.array(cam.view_proj()), np.array(cam.position())
    pos, nrm = bind_pose(jmodel)
    jlights = jpipe.make_lights(jcfg)
    packed = JSF.pack_materials(jmodel.materials, jmodel.atlas)
    jdims = pipeline_tpu.make_dims_fast(jcfg)

    @jax.jit
    def ref(pos, nrm, vp, eye, lights):
        return pipeline_tpu.render_frame_mega(jmodel, jcfg, jdims, packed, pos, nrm, vp, eye,
                                              lights, interpret=True, with_diag=True)

    jframe, jovf = ref(pos, nrm, vp, eye, jlights)
    t = torch.as_tensor
    pframe, povf = pipeline_gpu.render_frame_mega(
        pmodel, pcfg, pipeline_gpu.make_dims_fast(pcfg), t(pos), t(nrm), t(vp), t(eye),
        bridge.from_jax_arrays(jax.device_get(jlights), "cpu"))
    return np.asarray(jframe), int(jovf), pframe.numpy(), int(povf)


def check_mega_frames(jframe, jovf, pframe, povf, width=256, height=64):
    """The path-level bounds: >= 99 % of pixels within 1/255, the scene
    drawn, pair overflow equal."""
    assert pframe.shape == jframe.shape == (height, width, 3)
    assert np.isfinite(pframe).all()
    diff = np.abs(pframe - jframe).max(-1)
    assert (diff <= 1.0 / 255.0).mean() >= 0.99, (diff > 1 / 255).mean()
    assert (jframe.sum(-1) > 0.01).mean() > 0.05  # the scene draws
    assert povf == jovf == 0


@pytest.fixture(scope="module")
def runs():
    return run_frames()


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_step_frame_matches(runs, f):
    ref, port = runs[f]["jframe"], runs[f]["pframe"]
    assert port.shape == ref.shape == (H, W, 3)
    assert np.isfinite(port).all()
    diff = np.abs(port - ref).max(-1)
    assert (diff <= 1.0 / 255.0).mean() >= 0.99, (diff > 1 / 255).mean()
    assert (ref.sum(-1) > 0.01).mean() > 0.05  # the scene draws


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_step_state_matches(runs, f):
    js, ps = runs[f]["jstate"], runs[f]["pstate"]
    assert ps.time.item() == float(js.time)
    assert ps.diag.pair_overflow.item() == int(js.diag.pair_overflow) == 0
    np.testing.assert_allclose(ps.local_rot.numpy(), js.local_rot, atol=1e-5)
    np.testing.assert_array_equal(ps.morph_weights.numpy(), js.morph_weights)
    np.testing.assert_array_equal(ps.tween.active.numpy(), js.tween.active)
    assert ps.diag.contact_overflow.item() == int(js.diag.contact_overflow)
    jp, pp = js.physics, ps.physics
    assert pp.time_accum.item() == float(jp.time_accum)
    assert pp.initialized.item() and bool(jp.initialized)
    np.testing.assert_allclose(pp.position.numpy(), jp.position, atol=1e-5)
    np.testing.assert_allclose(pp.quat.numpy(), jp.quat, atol=1e-5)


def test_physics_moves_the_dynamic_body(runs):
    """The stop-ERP slack lets the dynamic body sag from its bone's pose
    (bone 2 at y = 2) while its spring joint holds it."""
    pos = runs[-1]["pstate"].physics.position
    assert 1e-3 < 2.0 - pos[1, 1].item() < 0.1


def test_morph_and_tween_change_the_frame(runs):
    assert np.abs(runs[1]["pframe"] - runs[0]["pframe"]).max() > 0.1


def _still_args(model):
    """(dt, view_proj, eye, lights, track, breath) of a still pose on the
    CPU, the camera of ``run_frames``."""
    from reze_tpu_torch.anim import sampler as psampler
    from reze_tpu_torch.render import pipeline as ppipe

    cam = jcam.Camera(alpha=0.0, beta=np.pi / 2, radius=3.6, target=(0.0, 1.9, 0.0),
                      aspect=W / H)
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    breath = {"mask": torch.zeros(j, dtype=torch.bool), "ranges": torch.zeros(j),
              "base": torch.tensor([[0.0, 0.0, 0.0, 1.0]] * j),
              "half_cycle": torch.tensor(2.0), "start": torch.tensor(float("inf"))}
    return (torch.tensor(1 / 60), torch.as_tensor(np.array(cam.view_proj())),
            torch.as_tensor(np.array(cam.position())),
            ppipe.make_lights(PT.EngineConfig(), "cpu"), psampler.empty_animation(j, nm, "cpu"),
            breath)


@pytest.mark.parametrize("change", [{"renderer": "vulkan"}])
def test_unported_paths_refused(change):
    """A renderer the engine does not have is refused (``renderer="xla"``,
    once refused here, runs the oracle: ``test_torch_xla_render.py``)."""
    cfg = PT.EngineConfig(width=W, height=H, enable_physics=False, **change)
    with pytest.raises(ValueError, match="renderer"):
        pmake_step(ptesting.make_test_model(device="cpu"), cfg)


@pytest.mark.parametrize("change", [{}, {"use_megakernel": False}])
def test_bilinear_paths_run(change):
    """``make_step`` with bilinear albedo on the megakernel path and the
    layered per-pass path (the quad composite; ``test_torch_parity.py``
    holds both to the JAX package): a drawn, finite frame that the lerp
    sets apart from the nearest frame."""
    model = ptesting.make_test_model(device="cpu")
    frames = []
    for bilinear in (False, True):
        cfg = PT.EngineConfig(width=W, height=H, enable_physics=False,
                              albedo_bilinear=bilinear, **change)
        frames.append(pmake_step(model, cfg)(PT.init_scene_state(model), *_still_args(model))[1])
    assert bool(torch.isfinite(frames[1]).all())
    assert (frames[1].sum(-1) > 0.01).float().mean() > 0.05
    assert (frames[1] - frames[0]).abs().max() > 0.01


def test_mat_mod_matches():
    """Material-morph alpha factors on the push table, as the JAX path
    applies them."""
    rng = np.random.default_rng(3)
    tab = rng.uniform(0, 1, (4, 7)).astype(np.float32)
    mm = [rng.uniform(-1, 2, 4).astype(np.float32) for _ in range(4)]
    a_scale, a_add, e_scale, e_add = (jnp.asarray(x) for x in mm)
    ref = jnp.asarray(tab)
    ref = ref.at[:, 0].set(jnp.clip(ref[:, 0] * a_scale + a_add, 0.0, 1.0))
    ref = ref.at[:, 1].set(jnp.clip(ref[:, 1] * e_scale + e_add, 0.0, 1.0))
    from reze_tpu_torch.kernels import shade_gpu as SG

    tables = SG.ShadeTables(torch.as_tensor(tab), None, None, None, 8)
    port = pipeline_gpu._apply_mat_mod(tables, [torch.as_tensor(x) for x in mm])
    np.testing.assert_allclose(port.push_tab.numpy(), np.asarray(ref), atol=1e-6)


def test_port_imports_without_jax():
    """Every module of the port imports with jax made unimportable."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import reze_tpu_torch\n"
        "for m in pkgutil.walk_packages(reze_tpu_torch.__path__, 'reze_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import reze_tpu_torch.step\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_default_to_the_card():
    """Every public function or method of the port that takes ``device``
    defaults to "cuda": a caller gets the CPU only by asking for it."""
    import reze_tpu_torch

    found = []
    for info in pkgutil.walk_packages(reze_tpu_torch.__path__, "reze_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns = [(f"{name}.{k}", v) for k, v in vars(obj).items()
                       if inspect.isfunction(v) and not k.startswith("_")]
            for qual, fn in fns:
                param = inspect.signature(fn).parameters.get("device")
                if param is not None:
                    found.append(f"{mod.__name__}.{qual}")
                    assert param.default == "cuda", (qual, param.default)
    for name in ("testing.make_test_model", "testing.random_frame_tables",
                 "anim.sampler.empty_animation", "bridge.from_jax_arrays",
                 "render.pipeline.make_lights", "camera.Camera.view_proj",
                 "camera.Camera.position"):
        assert f"reze_tpu_torch.{name}" in found
