"""Triangle setup, per-pass gather and the pair pack of the PyTorch port
against the JAX package.

400 seeded random triangles per pass of a 16x256 frame (4
tiles of 8x128) give tile segments of more than one 128-pair chunk.
Starts, counts, overflow and the enumeration are integer work and must be
equal; float rows (columns 0:37, which are all the frame kernel reads)
agree to rtol 1e-6 / atol 1e-5 (the packages sum the plane products in
their own order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu import testing as jtesting
from reze_tpu.core.types import EngineConfig
from reze_tpu.kernels import frame_tpu as FT
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import pipeline_tpu
from reze_tpu.render import raster as JR
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.render import pipeline as ppipe
from reze_tpu_torch.render import raster as PR

HP, WP = 16, 256
BY, BX = HP // 8, WP // 128
N_TRIS = (400,) * 7  # one shape: the eager JAX ops compile once
SPECS = pipeline_tpu._PASS_SPECS


def floats_close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=1e-6, atol=1e-5)


def cap_for(t):
    return -(-int(t * 4.0 + 1024) // 128) * 128


def build(lib, inputs, caps):
    """Setup + pack every pass with one package (``lib`` = "jax" | "torch").
    JAX runs op by op: under jit, XLA's CPU backend fuses a*b + c into one
    rounding, which moves plane constants with cancellation (ec = -(ea*ax
    + eb*ay)) by an ulp of the products, beyond this file's tolerance."""
    R, F = (JR, FT) if lib == "jax" else (PR, FG)
    arr = jnp.asarray if lib == "jax" else torch.as_tensor
    tris, parts = [], []
    for (cls, cull, outline), d, cap in zip(SPECS, inputs, caps):
        tri = R.setup_triangles(arr(d["corners_clip"]), arr(d["valid"]), WP, HP, cull)
        parts.append(F.pack_pass_part(
            tri, arr(d["corner_uv"]), arr(d["corner_nrm"]), arr(d["alpha"]),
            arr(d["is_hair"]), arr(d["ramp"]), arr(d["tex"]), arr(d["edge"]),
            BY, BX, cap, with_attrs=not outline))
        tris.append(tri)
    return tris, parts, F.pack_frame_rows(parts, BY, BX)


@pytest.fixture(scope="module")
def packed():
    inputs = ptesting.random_pass_inputs(11, N_TRIS)
    caps = [cap_for(t) for t in N_TRIS]
    return build("jax", inputs, caps), build("torch", inputs, caps)


def test_setup_triangles_matches(packed):
    (jtris, _, _), (ptris, _, _) = packed
    for jt, pt in zip(jtris, ptris):
        np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(jt.valid))
        for name in ("ea", "eb", "ec", "z", "inv_w", "sx", "sy"):
            floats_close(getattr(pt, name), getattr(jt, name))
        ok = np.asarray(jt.valid)
        floats_close(pt.inv_area2.numpy()[ok], np.asarray(jt.inv_area2)[ok])


def test_pack_pass_part_enumeration_exact(packed):
    (_, jparts, _), (_, pparts, _) = packed
    for (jtab, jbin, jok, jtri, jtot), (ptab, pbin, pok, ptri, ptot) in zip(jparts, pparts):
        assert int(ptot) == int(jtot)
        ok = np.asarray(jok)
        np.testing.assert_array_equal(pok.numpy(), ok)
        np.testing.assert_array_equal(ptri.numpy()[ok], np.asarray(jtri)[ok])
        np.testing.assert_array_equal(pbin.numpy()[ok], np.asarray(jbin)[ok])
        floats_close(ptab.numpy()[:, :FG.ROW_USED], np.asarray(jtab)[:, :FG.ROW_USED])


def test_pack_frame_rows_matches(packed):
    (_, _, jft), (_, _, pft) = packed
    counts = np.asarray(jft.counts)
    assert counts[0].max() > FG.CHUNK  # a segment spans more than one chunk
    np.testing.assert_array_equal(pft.starts.numpy(), np.asarray(jft.starts))
    np.testing.assert_array_equal(pft.counts.numpy(), counts)
    assert int(pft.overflow) == int(jft.overflow) == 0
    # same rows at the same positions: pair order within every segment
    jrows = np.asarray(jft.rows)
    assert pft.rows.shape[0] == jrows.shape[0]
    floats_close(pft.rows.numpy()[:, :FG.ROW_USED], jrows[:, :FG.ROW_USED])


def test_pair_overflow_counted():
    inputs = ptesting.random_pass_inputs(11, N_TRIS)
    caps = [cap_for(t) for t in N_TRIS]
    caps[0] = 256  # far fewer slots than pass 0's pairs
    (_, jparts, jft), (_, pparts, pft) = build("jax", inputs, caps), build("torch", inputs, caps)
    total0 = int(jparts[0][4])
    assert total0 > 256
    assert int(pft.overflow) == int(jft.overflow) == total0 - 256
    np.testing.assert_array_equal(pft.starts.numpy(), np.asarray(jft.starts))
    np.testing.assert_array_equal(pft.counts.numpy(), np.asarray(jft.counts))


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_gather_pass_matches(spec):
    """Per-class triangle slice and projection; outline passes expand the
    inverted hull along the skinned normals."""
    cls, _, outline = SPECS[spec]
    jmodel = jtesting.make_test_model()
    pmodel = ptesting.make_test_model(device="cpu")
    rng = np.random.default_rng(12)
    v = jmodel.geometry.positions.shape[0]
    pos = (np.asarray(jmodel.geometry.positions)
           + 0.05 * rng.normal(size=(v, 3))).astype(np.float32)
    nrm = rng.normal(size=(v, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uvs = rng.uniform(0, 1, (v, 2)).astype(np.float32)
    vp = rng.normal(size=(4, 4)).astype(np.float32)
    cfg = EngineConfig()
    jd = jpipe._gather_pass(jmodel, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(vp),
                            cls, outline, cfg.outline_scale, jnp.asarray(uvs))
    pd = ppipe._gather_pass(pmodel, torch.as_tensor(pos), torch.as_tensor(nrm),
                            torch.as_tensor(vp), cls, outline, cfg.outline_scale,
                            torch.as_tensor(uvs))
    for name in ("corners_clip", "corner_uv", "corner_nrm", "corner_pos"):
        floats_close(getattr(pd, name), getattr(jd, name))
    np.testing.assert_array_equal(pd.tri_mat.numpy(), np.asarray(jd.tri_mat))
    np.testing.assert_array_equal(pd.valid.numpy(), np.asarray(jd.valid))
