"""A model with an empty draw class renders on every route.

Two variants of ``testing.make_pmx_spec(0, "small")``
(``testing.empty_class_spec``): "hair", its hair material renamed into the
opaque class (the hair and hair outline passes hold no triangle), and
"outline", the edge flag cleared on its transparent material (the
transparent outline pass holds none). Each renders in its bind pose
(``make_step`` with physics off and no clip) at 128x64 through every
route: the four megakernels ("group", "hybrid", "mxu", "stream"), the
per-pass renderer layered and not, the parity config, the crowd's
"group" and "stream" routes at two characters, and ``renderer="xla"``.
Its witness is the same scene with one more triangle in the emptied class
(a copy of the class's material, edge flag kept) behind every camera, so
that the class is not empty and the triangle makes no pair. The frame of
each route must equal its witness's bit for bit.

The port's oracle frame of the "hair" variant is also held to the JAX
package's ``render_frame`` within 1/255 on >= 99.5 % of pixels. The JAX
oracle bins and rasterizes an empty pass (its bin lists are padding and
its tables carry a dead entry) but then fails to shade it (its
``shading.interpolate`` gathers from an empty corner table), so it
renders the witness, which the port's frame equals. That is the file's
one JAX compile.
"""

import os

import jax
import numpy as np
import pytest
import torch

from reze_tpu.core import types as JT
from reze_tpu.core.build import load_model as jload_model
from reze_tpu.render import pipeline as jpipe
from reze_tpu_torch import distrib, testing
from reze_tpu_torch.anim import sampler
from reze_tpu_torch.camera import Camera
from reze_tpu_torch.core.build import BuiltModel
from reze_tpu_torch.core.types import CLASS_HAIR, CLASS_TRANSPARENT, EngineConfig
from reze_tpu_torch.core.types import init_scene_state
from reze_tpu_torch.render import pipeline
from reze_tpu_torch.step import make_step
from test_torch_frame import _one_thread  # noqa: F401

W, H = 128, 64
BASE = dict(width=W, height=H, enable_physics=False)
TARGET = (0.0, 12.5, 0.0)
RADIUS = 14.0
CROWD_ALPHAS = (-0.15, 0.15)  # the crowd's cameras, about the single camera
PARITY = dict(albedo_bilinear=True, albedo_mips=False, albedo_half_visible=False,
              albedo_half_occluded=False)
ROUTES = {
    "group": {}, "hybrid": dict(rasterizer="hybrid"), "mxu": dict(rasterizer="mxu"),
    "stream": dict(rasterizer="stream"), "per_pass": dict(use_megakernel=False),
    "non_layered": dict(layered_shading=False), "parity": PARITY,
    "crowd_group": dict(rasterizer="group"), "crowd_stream": dict(rasterizer="stream"),
    "xla": dict(renderer="xla"),
}
# the emptied class of each variant: (field of Geometry, class)
EMPTIED = {"hair": (("class_ranges", CLASS_HAIR), ("outline_class_ranges", CLASS_HAIR)),
           "outline": (("outline_class_ranges", CLASS_TRANSPARENT),)}
JAX_TOL, JAX_FRAC = 1.0 / 255.0, 0.995


def camera(d_alpha=0.0):
    cfg = EngineConfig()
    return Camera(alpha=cfg.camera_alpha + d_alpha, beta=cfg.camera_beta, radius=RADIUS,
                  target=TARGET, aspect=W / H)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("empty_class"))
    spec = testing.make_pmx_spec(0, "small")
    testing.write_scene(directory, spec)
    # three times the camera distance from the target, on the camera's
    # side: behind the single camera and the crowd's
    eye, target = camera().position("cpu").numpy(), np.asarray(TARGET, np.float32)
    behind = target + 3.0 * (eye - target)
    specs, models = {}, {}
    for kind in EMPTIED:
        for witness in (False, True):
            specs[kind, witness] = testing.empty_class_spec(spec, kind,
                                                            behind if witness else None)
            models[kind, witness] = BuiltModel(specs[kind, witness].model, directory,
                                               EngineConfig(**BASE), device="cpu").arrays
    return dict(directory=directory, specs=specs, models=models, frames={})


def inputs(model, n=None):
    """The step's arguments for ``model`` in its bind pose (no clip): one
    camera, or with ``n`` the crowd's cameras."""
    j, nm = model.skeleton.j, model.morphs.offsets.shape[0]
    base = torch.zeros((j, 4))
    base[:, 3] = 1.0
    breath = {"mask": torch.zeros(j, dtype=torch.bool), "ranges": torch.zeros(j), "base": base,
              "half_cycle": torch.tensor(2.0), "start": torch.tensor(float("inf"))}
    cams = [camera()] if n is None else [camera(a) for a in CROWD_ALPHAS[:n]]
    vp = torch.stack([c.view_proj("cpu") for c in cams])
    eye = torch.stack([c.position("cpu") for c in cams])
    if n is None:
        vp, eye = vp[0], eye[0]
    return (torch.tensor(1 / 60), vp, eye, pipeline.make_lights(EngineConfig(), "cpu"),
            sampler.empty_animation(j, nm, "cpu"), breath)


def render(s, kind, witness, route):
    """-> (frames (C, H, W, 3), pair overflow (C,)) of one route, cached."""
    key = (kind, witness, route)
    if key not in s["frames"]:
        model = s["models"][kind, witness]
        cfg = EngineConfig(**BASE, **ROUTES[route])
        if route.startswith("crowd"):
            step = distrib.make_batched_step(model, cfg)
            state, args = distrib.batch_state(model, len(CROWD_ALPHAS)), inputs(
                model, len(CROWD_ALPHAS))
        else:
            step, state, args = make_step(model, cfg), init_scene_state(model), inputs(model)
        state, frame = step(state, *args)
        s["frames"][key] = (frame.reshape((-1, H, W, 3)),
                            state.diag.pair_overflow.reshape(-1))
    return s["frames"][key]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", list(EMPTIED))
def test_empty_class_renders_as_its_witness(scenes, kind, route):
    for field, cls in EMPTIED[kind]:
        assert getattr(scenes["models"][kind, False].geometry, field)[cls][2] == 0
        assert getattr(scenes["models"][kind, True].geometry, field)[cls][1] == 1
    frames, overflow = render(scenes, kind, False, route)
    witness, w_overflow = render(scenes, kind, True, route)
    assert frames.shape == witness.shape and torch.isfinite(frames).all()
    assert torch.equal(frames, witness), (frames - witness).abs().max()
    assert ((frames.sum(-1) > 0.01).float().mean((1, 2)) > 0.1).all()  # the model draws
    assert int(overflow.max()) == int(w_overflow.max()) == 0
    if route.startswith("crowd"):
        assert not torch.equal(frames[0], frames[1])  # two cameras


def test_xla_empty_class_matches_jax(scenes):
    """The port's oracle frame of the "hair" variant against the JAX
    package's ``render_frame`` of its witness on the same skinned
    vertices."""
    path = os.path.join(scenes["directory"], "witness_hair.pmx")
    testing.write_pmx(path, scenes["specs"]["hair", True].model)
    jcfg = JT.EngineConfig(**BASE, renderer="xla")
    jmodel = jload_model(path, jcfg).arrays
    assert jmodel.geometry.class_ranges[JT.CLASS_HAIR][1] == 1
    pmodel = scenes["models"]["hair", True]
    cfg = EngineConfig(**BASE, renderer="xla")
    state, (dt, vp, eye, lights, track, breath) = init_scene_state(pmodel), inputs(pmodel)
    out = make_step(pmodel, cfg).simulate(state, dt, track, breath)
    pos, nrm, uvs, mat_mod = out[7:]
    dims = jpipe.make_dims(jcfg)

    @jax.jit
    def ref(pos, nrm, vp, eye, uvs, mat_mod):
        return jpipe.render_frame(jmodel, jcfg, dims, pos, nrm, vp, eye,
                                  jpipe.make_lights(jcfg), uvs=uvs, mat_mod=mat_mod)

    np_ = lambda x: None if x is None else x.numpy()  # noqa: E731
    want = np.asarray(ref(pos.numpy(), nrm.numpy(), vp.numpy(), eye.numpy(), np_(uvs),
                          None if mat_mod is None else tuple(m.numpy() for m in mat_mod)))
    got = render(scenes, "hair", False, "xla")[0][0].numpy()
    assert got.shape == want.shape == (H, W, 3)
    diff = np.abs(got - want).max(-1)
    assert (diff <= JAX_TOL).mean() >= JAX_FRAC, ((diff <= JAX_TOL).mean(), float(diff.max()))
    assert (want.sum(-1) > 0.01).mean() > 0.1
