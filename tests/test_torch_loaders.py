"""The port's loaders against the JAX package's on files written by
``reze_tpu_torch.testing`` from numpy seeds.

* PMX: one case per index size (1, 2, 4), text encoding (UTF-16LE,
  UTF-8) and additional-UV count (0, 2), each a small model with every
  deform type, every morph kind 0-10, the three body shapes and two
  joints: ``reze_tpu.formats.pmx.load_pmx`` and the port's give equal
  models (every array exact, dtype included, every field equal); the
  port's native parse equals its Python parse; a bad deform type raises
  ``ValueError`` in both packages. The flagship-width model parses equal
  in both packages too, at the flagship's counts.
* VMD: the same equality, with names cut inside a Shift-JIS character
  at the 15- and 20-byte limits, morph and camera frames.
* Textures: the port's decoder equals PIL's RGBA on every PNG, BMP and
  TGA variant it claims, written by PIL and by the port's writers.
* ``load_model``: the port's tables equal ``bridge.from_jax_arrays`` of
  the JAX package's, tensor by tensor and dtype included, under the
  default config and ``bench.py``'s parity flags; the name tables equal.
* Tracks: ``build_animation`` and ``build_camera_track`` exact;
  ``sample_camera`` and ``camera_view_proj`` within 1e-6.
"""

import dataclasses
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.anim import sampler as jsampler
from reze_tpu.core import build as jbuild
from reze_tpu.core import types as JT
from reze_tpu.formats import pmx as jpmx
from reze_tpu.formats import vmd as jvmd
from reze_tpu_torch import bridge, testing
from reze_tpu_torch.anim import sampler as psampler
from reze_tpu_torch.core import build as pbuild
from reze_tpu_torch.core import types as PT
from reze_tpu_torch.formats import image as pimage
from reze_tpu_torch.formats import native as pnative
from reze_tpu_torch.formats import pmx as ppmx
from reze_tpu_torch.formats import vmd as pvmd
from test_torch_frame import _one_thread  # noqa: F401

SEED = 3
PARITY = dict(albedo_bilinear=True, albedo_mips=False, albedo_half_visible=False,
              albedo_half_occluded=False)


def assert_same(a, b, path="model"):
    """Equal trees: dataclasses of the same name field by field, lists item
    by item, arrays exactly with their dtype, everything else by ``==``."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def small():
    return testing.make_pmx_spec(SEED, "small")


@pytest.fixture(scope="module")
def scene(small, tmp_path_factory):
    return testing.write_scene(str(tmp_path_factory.mktemp("scene")), small)


@pytest.mark.parametrize("add_uv", [0, 2])
@pytest.mark.parametrize("encoding", ["utf-16-le", "utf-8"])
@pytest.mark.parametrize("index_size", [1, 2, 4])
def test_pmx_parse_matches(small, tmp_path, index_size, encoding, add_uv):
    model = dataclasses.replace(small.model, additional_uvs=(
        small.model.additional_uvs if add_uv else None))
    assert model.additional_uvs is None or model.additional_uvs.shape[1] == add_uv
    path = str(tmp_path / "m.pmx")
    testing.write_pmx(path, model, encoding, index_size)
    with open(path, "rb") as f:
        head = f.read(17)
    assert head[9] == (0 if encoding == "utf-16-le" else 1) and head[10] == add_uv
    assert set(head[11:17]) == {index_size}
    ref = jpmx.load_pmx(path)
    got = ppmx.load_pmx(path)
    assert_same(ref, got)
    assert_same(got, ppmx.load_pmx(path, native=False))
    # the file holds what was written
    for name in ("positions", "normals", "uvs", "deform_types", "indices", "edge_scale"):
        np.testing.assert_array_equal(getattr(got, name), getattr(model, name))
    assert [b.name for b in got.bones] == [b.name for b in model.bones]
    assert sorted({int(k) for k in got.deform_types}) == [0, 1, 2, 3, 4]
    assert sorted({m.kind for m in got.morphs}) == list(range(11))
    assert sorted({b.shape for b in got.rigid_bodies}) == [0, 1, 2] and got.joints
    assert got.comment == model.comment

    # a deform type the parsers refuse
    bad = dataclasses.replace(model, deform_types=model.deform_types.copy())
    bad.deform_types[7] = 9
    testing.write_pmx(path, bad, encoding, index_size)
    for load in (jpmx.load_pmx, ppmx.load_pmx, lambda p: ppmx.load_pmx(p, native=False)):
        with pytest.raises(ValueError, match="deform type 9"):
            load(path)


def test_flagship_parse_matches(tmp_path):
    """The flagship-width model: both packages parse it equal, at the
    flagship's counts, and the port builds its class split."""
    spec = testing.make_pmx_spec(SEED, "flagship")
    pmx_path, vmd_path = testing.write_scene(str(tmp_path), spec)
    got = ppmx.load_pmx(pmx_path)
    assert_same(jpmx.load_pmx(pmx_path), got)
    assert_same(jvmd.load_vmd(vmd_path), pvmd.load_vmd(vmd_path))
    assert got.positions.shape == (28842, 3) and got.indices.size == 101199
    assert (len(got.materials), len(got.bones), len(got.morphs)) == (19, 349, 72)
    assert (len(got.rigid_bodies), len(got.joints)) == (257, 406)
    assert sum(m.index_count for m in got.materials) == got.indices.size
    assert {int(k) for k in got.deform_types} >= {2, 3}
    assert [b for b in got.bones if b.is_ik] and any(b.append_parent >= 0 for b in got.bones)
    built = pbuild.load_model(pmx_path, PT.EngineConfig(), device="cpu")
    g = built.arrays.geometry
    assert [r[1] for r in g.class_ranges] == [26583, 928, 1347, 4875]
    assert built.arrays.physics.n_bodies == 257 and built.arrays.physics.n_joints == 406
    assert built.arrays.morphs.n_morphs == 72 and built.arrays.ik.n_chains == 4


def _cut_motion(motion):
    """The clip with names at the format's limits: bone and morph names
    past 15 bytes and a model name past 20, each cut inside a Shift-JIS
    character, and one bone name of exactly 15 bytes."""
    long_names = ["左腕捩れ補助ボーン", "センター補助あ1", "abcdefghijklmnopq"]
    names = [long_names[i % 3] if i % 4 == 0 else n for i, n in enumerate(motion.bone_names)]
    morphs = ["まばたき右目閉じ" if i % 3 == 0 else n for i, n in enumerate(motion.morph_names)]
    return dataclasses.replace(motion, model_name="aテストモデルの名前が長い", bone_names=names,
                               morph_names=morphs)


def test_vmd_parse_matches(small, tmp_path):
    motion = _cut_motion(small.motion)
    assert len("左腕捩れ補助ボーン".encode("shift_jis")) == 18
    assert len("センター補助あ1".encode("shift_jis")) == 15
    path = str(tmp_path / "c.vmd")
    testing.write_vmd(path, motion)
    ref = jvmd.load_vmd(path)
    got = pvmd.load_vmd(path)
    assert_same(ref, got)
    assert_same(got, pvmd.load_vmd(path, native=False))
    assert_same(ref.grouped_bone_tracks(), got.grouped_bone_tracks())
    assert_same(ref.grouped_morph_tracks(), got.grouped_morph_tracks())
    assert ref.duration_seconds() == got.duration_seconds() == 2.0
    # cut inside a character: the decoder's replacement; 15 bytes: whole
    assert "センター補助あ1" in got.bone_names
    assert any(n.startswith("左腕捩れ補助ボ") and n != "左腕捩れ補助ボーン"
               for n in got.bone_names)
    assert got.model_name.startswith("aテストモデルの名前") and got.camera_frames.size == 3
    np.testing.assert_array_equal(got.bone_interp, motion.bone_interp)
    np.testing.assert_array_equal(got.camera_fov, motion.camera_fov)


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


def _image(seed, h=13, w=17):
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    y, x = np.mgrid[:h, :w]
    smooth = np.stack([x * 12, y * 15, (x + y) * 5, 255 - x * 7], -1).astype(np.uint8)
    return np.where((y < h // 2)[..., None], smooth, noise)


def _pil_variants():
    """(name, writer(path)) of every variant the decoder claims, written
    by PIL."""
    from PIL import Image

    img = _image(0)
    rgb = Image.fromarray(img[..., :3])
    pal = rgb.quantize(200)
    out = [(f"pil_{m}.png", lambda p, m=m: Image.fromarray(img).convert(m).save(p))
           for m in ("RGBA", "RGB", "L", "LA")]
    out += [("pil_opt_rgba.png", lambda p: Image.fromarray(img).save(p, optimize=True)),
            ("pil_P.png", lambda p: pal.save(p, bits=8)),
            ("pil_P_trns.png", lambda p: pal.save(p, transparency=bytes(range(0, 200, 3)))),
            ("pil_RGB_trns.png", lambda p: rgb.save(p, transparency=tuple(
                int(v) for v in img[0, 0, :3]))),
            ("pil_L_trns.png", lambda p: rgb.convert("L").save(p, transparency=int(
                rgb.convert("L").getpixel((0, 0))))),
            ("pil_RGB.bmp", lambda p: rgb.save(p)),
            ("pil_RGBA.bmp", lambda p: Image.fromarray(img).save(p)),
            ("pil_P.bmp", lambda p: pal.save(p)),
            ("pil_L.bmp", lambda p: rgb.convert("L").save(p))]
    for mode in ("RGB", "RGBA"):
        for rle in (False, True):
            for orient in (-1, 1):
                out.append((f"pil_{mode}_rle{int(rle)}_o{orient}.tga",
                            lambda p, mode=mode, rle=rle, orient=orient: Image.fromarray(
                                img).convert(mode).save(p, rle=rle, orientation=orient)))
    return out


def _port_variants():
    """(name, writer(path)) of the port's own writers' variants."""
    img = _image(1)
    idx = img[..., 0] % 60
    palette = np.random.default_rng(2).integers(0, 256, (60, 3), dtype=np.uint8)
    out = [(f"own_f{f}_c{c}.png", lambda p, f=f, c=c: testing.write_png(
        p, img[..., :c] if c > 1 else img[..., 0], filters=[f])) for f in range(5)
        for c in (1, 2, 3, 4)]
    out += [("own_mixed.png", lambda p: testing.write_png(p, img)),
            ("own_P.png", lambda p: testing.write_png(p, idx, palette=palette,
                                                      transparency=bytes(range(0, 250, 7)))),
            ("own_rgb.bmp", lambda p: testing.write_bmp(p, img[..., :3])),
            ("own_top.bmp", lambda p: testing.write_bmp(p, img[..., :3], top_down=True)),
            ("own_32.bmp", lambda p: testing.write_bmp(p, img)),
            ("own_bgra.bmp", lambda p: testing.write_bmp(p, img, bitfields=True)),
            ("own_P.bmp", lambda p: testing.write_bmp(p, idx, palette=palette)),
            ("own_P_top.bmp", lambda p: testing.write_bmp(p, idx, palette=palette,
                                                          top_down=True)),
            ("own_top_rtl.tga", lambda p: testing.write_tga(p, img, top=True,
                                                            right_to_left=True)),
            ("own_rle_rtl.tga", lambda p: testing.write_tga(p, img[..., :3], rle=True,
                                                            right_to_left=True))]
    return out


@pytest.mark.parametrize("source", ["pil", "port"])
def test_textures_match_pil(tmp_path, source):
    """Every claimed variant decodes to PIL's RGBA, bit for bit."""
    pytest.importorskip("PIL")
    from PIL import Image

    variants = _pil_variants() if source == "pil" else _port_variants()
    assert len(variants) >= 17
    for name, write in variants:
        path = str(tmp_path / name)
        write(path)
        with open(path, "rb") as f:
            got = pimage.decode_image(f.read(), name)
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGBA"))
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(pimage.load_image(path), want, err_msg=name)


def test_texture_fallbacks(tmp_path, monkeypatch):
    """A missing file loads as None; another format goes to PIL, and
    without PIL warns once, naming the file, and loads as missing."""
    pytest.importorskip("PIL")
    from PIL import Image

    assert pimage.load_image(str(tmp_path / "none.png")) is None
    gif = str(tmp_path / "t.gif")
    Image.fromarray(_image(3)[..., :3]).convert("P").save(gif)
    with Image.open(gif) as im:
        np.testing.assert_array_equal(pimage.load_image(gif), np.asarray(im.convert("RGBA")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(pimage, "_warned", set())
    with pytest.warns(UserWarning, match="t.gif"):
        assert pimage.load_image(gif) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pimage.load_image(gif) is None  # once


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output: no silent
    Python parse."""
    bad = tmp_path / "reze_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        pnative.library()


# ---------------------------------------------------------------------------
# load_model and the tracks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", ["default", "parity"])
def test_load_model_matches(scene, flags):
    kw = {} if flags == "default" else PARITY
    ref = jbuild.load_model(scene[0], JT.EngineConfig(**kw))
    got = pbuild.load_model(scene[0], PT.EngineConfig(**kw), device="cpu")
    want = bridge.from_jax_arrays(jax.device_get(ref.arrays), "cpu")
    assert_same(want, got.arrays, "arrays")
    assert (got.arrays.atlas.flat_quad is not None) == (flags == "parity")
    assert got.arrays.atlas.texels.shape[0] == 4 and got.arrays.morphs.n_morphs == 16
    assert got.bone_name_to_id == ref.bone_name_to_id
    assert got.bone_names == ref.bone_names
    assert got.morph_name_to_id == ref.morph_name_to_id


def test_tracks_match(scene):
    """build_animation and build_camera_track exact; sample_camera and
    camera_view_proj within 1e-6, before, between and after the keys."""
    ref_model = jbuild.load_model(scene[0])
    motion_j, motion_p = jvmd.load_vmd(scene[1]), pvmd.load_vmd(scene[1])
    j, nm = ref_model.arrays.skeleton.j, ref_model.arrays.morphs.offsets.shape[0]
    args = (ref_model.bone_name_to_id, ref_model.morph_name_to_id, j, nm)
    want = bridge.from_jax_arrays(jsampler.build_animation(motion_j, *args), "cpu")
    got = psampler.build_animation(motion_p, *args, device="cpu")
    assert_same(want, got, "track")
    assert int(got.has_track.sum()) >= 6 and got.duration == 2.0
    assert_same(bridge.from_jax_arrays(jsampler.empty_animation(j, nm), "cpu"),
                psampler.empty_animation(j, nm, "cpu"), "empty")

    jcam, pcam = jsampler.build_camera_track(motion_j), psampler.build_camera_track(
        motion_p, device="cpu")
    for name in ("times", "distance", "target", "rotation", "fov"):
        assert_same(torch.as_tensor(np.array(getattr(jcam, name))), getattr(pcam, name), name)
    assert jcam.n_keys == pcam.n_keys == 3
    for t in (-0.5, 0.0, 0.37, 1.0, 1.61, 2.0, 3.5):
        ref = jsampler.sample_camera(jcam, jnp.float32(t))
        out = psampler.sample_camera(pcam, torch.tensor(t, dtype=torch.float32))
        for a, b in zip(ref, out):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
        vp_ref, eye_ref = jsampler.camera_view_proj(*ref, 16 / 9, 0.05, 1000.0)
        vp, eye = psampler.camera_view_proj(*out, 16 / 9, 0.05, 1000.0)
        np.testing.assert_allclose(vp.numpy(), np.asarray(vp_ref), atol=1e-6, rtol=0)
        np.testing.assert_allclose(eye.numpy(), np.asarray(eye_ref), atol=1e-6, rtol=0)
    assert psampler.build_camera_track(dataclasses.replace(
        motion_p, camera_frames=np.zeros(0, np.int64)), device="cpu") is None
