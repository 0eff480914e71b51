"""The per-pass renderer's kernels against the JAX package: the pair pack
``raster_gpu.pack_tables``, the raster pass (``raster_pass``, run here
through its plain torch twin) against ``raster_pass_tpu`` and the stack
shade (``shade_stack``) against ``shade_stack_tpu``, both Pallas kernels
in interpret mode, on seeded inputs: 300 random triangles per pass in a
64x256 frame (2x2 tiles of 32x128; one tile holds more than 100 pairs) and
a random fragment stack with empty layer-0 tiles.

Bounds and why:

* pair ids, starts, counts and overflow are integer work: exact. Float
  rows to rtol 1e-6 / atol 1e-5 (the packages sum plane products in their
  own order);
* raster pass: material id (which names the winning triangle) and cover
  equal on >= 99.5 % of pixels, depth buffer within 1e-6 on >= 99.5 % of
  samples; where the material id agrees and is >= 0, z and attributes to
  rtol 1e-5 / atol 1e-5, attributes also to 4 ulps of their plane's
  largest term (those terms reach a few hundred and cancel). XLA's CPU
  backend fuses ``a*b + c`` into one rounding inside the jitted kernel and
  the port rounds every product, so every plane value (a stored depth too)
  can differ in its last bits, and a sample on an edge or at an exact depth
  tie can go the other way: those flips are the pixels outside the 99.5 %;
* stack shade: ``testing.compare_shade`` (decoded texel index, ``a_eff``
  and footprint step equal on >= 99.5 % of pixels, lit rgb and rim within
  1e-4), for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.core.types import EngineConfig
from reze_tpu.kernels import raster_tpu as RT
from reze_tpu.kernels import shade_tpu as ST
from reze_tpu.render import pipeline as jpipe
from reze_tpu.render import raster as jraster
from reze_tpu_torch import bridge
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import raster_gpu as RG
from reze_tpu_torch.kernels import shade_gpu as SG
from reze_tpu_torch.render import raster as praster

HP, WP = 64, 256
BY, BX = HP // RG.TILE_H, WP // RG.TILE_W
N_TRIS = (300, 300)
RIM = 0.45
SAME_FRAC = 0.995
Z_TOL = 1e-6  # depths lie in [0, 1]: a few float32 ulps


def _pack(lib, d, hp, wp):
    """setup_triangles + pack_tables of one pass with one package. JAX runs
    op by op (under jit XLA fuses a*b + c in the setup's cancelling plane
    constants beyond the row tolerance)."""
    R, P, arr = (jraster, RT, jnp.asarray) if lib == "jax" else (praster, RG, torch.as_tensor)
    tri = R.setup_triangles(arr(d["corners_clip"]), arr(d["valid"]), wp, hp, R.CULL_NONE)
    return P.pack_tables(tri, arr(d["corner_uv"]), arr(d["corner_nrm"]),
                         arr(np.arange(len(d["valid"]), dtype=np.int32)),
                         hp // RG.TILE_H, wp // RG.TILE_W)


def _frame_covering_triangles(n, seed):
    """``n`` triangles that each cover a whole frame (w = 1)."""
    rng = np.random.default_rng(seed)
    big = np.array([[-4.0, -4.0], [4.0, -4.0], [0.0, 8.0]])
    xy = big * rng.uniform(1.0, 1.5, (n, 1, 1)) + rng.uniform(-0.5, 0.5, (n, 1, 2))
    clip = np.concatenate([xy, rng.uniform(0.1, 0.9, (n, 3, 1)), np.ones((n, 3, 1))], -1)
    return dict(corners_clip=clip.astype(np.float32), valid=np.ones(n, bool),
                corner_uv=rng.uniform(0, 1, (n, 3, 2)).astype(np.float32),
                corner_nrm=np.tile(np.float32([0, 0, -1]), (n, 3, 1)))


def test_pack_tables_matches():
    d = ptesting.random_pass_inputs(11, N_TRIS[:1])[0]
    j, p = _pack("jax", d, HP, WP), _pack("torch", d, HP, WP)
    assert p.ids.shape == j.ids.shape == (RG.pair_capacity(N_TRIS[0]),)
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(p.starts.numpy(), np.asarray(j.starts))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    assert int(p.overflow) == int(j.overflow) == 0
    assert np.asarray(j.counts).max() > 100
    np.testing.assert_allclose(p.tab.numpy(), np.asarray(j.tab), rtol=1e-6, atol=1e-5)


def test_pack_tables_overflow_matches():
    """300 frame-covering triangles in a 512x1024 frame (128 tiles) give
    38400 pairs: the cap of 16384 drops the tail of the draw-order list."""
    d = _frame_covering_triangles(300, 3)
    j, p = _pack("jax", d, 512, 1024), _pack("torch", d, 512, 1024)
    assert int(p.overflow) == int(j.overflow) == 300 * 128 - 16384
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(p.starts.numpy(), np.asarray(j.starts))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))


def test_pack_tables_takes_a_capacity():
    """The 38400 pairs of the overflow case fit a list of 38400 slots: every
    tile lists all 300 triangles in draw order; a smaller list drops the
    rest."""
    d = _frame_covering_triangles(300, 3)
    tri = praster.setup_triangles(torch.as_tensor(d["corners_clip"]),
                                  torch.as_tensor(d["valid"]), 1024, 512, praster.CULL_NONE)
    args = (tri, torch.as_tensor(d["corner_uv"]), torch.as_tensor(d["corner_nrm"]),
            torch.arange(300), 512 // RG.TILE_H, 1024 // RG.TILE_W)
    p = RG.pack_tables(*args, cap=300 * 128)
    assert p.ids.shape == (300 * 128,) and int(p.overflow) == 0
    assert (p.counts == 300).all()
    np.testing.assert_array_equal(p.ids.numpy().reshape(128, 300),
                                  np.tile(np.arange(300), (128, 1)))
    assert int(RG.pack_tables(*args, cap=1000).overflow) == 300 * 128 - 1000


def test_untouched_bands_keep_their_depths():
    """The twin, as the kernel, tests depth only in the 8-row bands that a
    pair's y range touches (``testing.touched_bands``): from a seeded
    non-uniform depth buffer, the other bands keep their depths and draw
    nothing."""
    hp, wp = 128, 512
    tb = ptesting.random_raster_tables(4, (8,), hp, wp, device="cpu")[0]
    touched, pair_bands = ptesting.touched_bands(tb, wp)
    assert 0 < int(touched.sum()) < touched.numel() and pair_bands >= int(touched.sum())
    z0 = torch.as_tensor(np.random.default_rng(5).uniform(0.2, 1.0, (4, hp, wp)),
                         dtype=torch.float32)
    z, g = RG.raster_pass_twin(tb, z0.clone(), bx=wp // RG.TILE_W, depth_write=True)
    by, bx = hp // RG.TILE_H, wp // RG.TILE_W
    band_px = touched.reshape(by, bx, RG.BANDS).permute(0, 2, 1)[:, :, None, :, None].expand(
        by, RG.BANDS, RG.BAND_H, bx, RG.TILE_W).reshape(hp, wp)
    assert (z[:, ~band_px] == z0[:, ~band_px]).all()
    assert (g[RG.CH_MAT][~band_px] == -1).all()
    assert (z[:, band_px] != z0[:, band_px]).any()


def test_pair_capacity_grows_with_the_pass():
    assert RG.pair_capacity(1) == RG.pair_capacity(8192) == 16384
    assert RG.pair_capacity(8193) == 32768
    assert RG.pair_capacity(3 * 8192 + 5) == 4 * 16384


# two chained passes per sample count: (depth_write, with_attrs) of each
CHAINS = {4: ((True, True), (False, False)), 1: ((True, False), (False, True))}


def _jax_chain(chain):
    """One jitted function (one compile) running the passes of ``chain``."""
    @jax.jit
    def ref(jtabs, zbuf):
        res = []
        for jt, (dw, attrs) in zip(jtabs, chain):
            zbuf, gbuf = RT.raster_pass_tpu(jt, zbuf, bx=BX, depth_write=dw,
                                            with_attrs=attrs, interpret=True)
            res.append((zbuf, gbuf))
        return res

    return ref


@pytest.fixture(scope="module")
def raster_runs():
    """Per sample count, both passes of the chain with both packages, on
    the port's tables; the second pass takes the first's depth buffer."""
    tabs = ptesting.random_raster_tables(11, N_TRIS, HP, WP, device="cpu")
    jtabs = [RT.PassTables(*(jnp.asarray(x.numpy()) for x in t)) for t in tabs]
    out = {}
    for s, chain in CHAINS.items():
        jres = jax.device_get(_jax_chain(chain)(jtabs, jnp.ones((s, HP, WP))))
        zbuf = torch.ones((s, HP, WP))
        pres = []
        for t, (dw, attrs) in zip(tabs, chain):
            zbuf, gbuf = RG.raster_pass(t, zbuf, bx=BX, depth_write=dw, with_attrs=attrs)
            pres.append((zbuf.clone().numpy(), gbuf.numpy()))
        out[s] = (jres, pres)
    out["tabs"] = tabs
    return out


@pytest.mark.parametrize("s", sorted(CHAINS))
@pytest.mark.parametrize("p", range(2))
def test_raster_pass_matches(raster_runs, s, p):
    (jz, jg), (pz, pg) = raster_runs[s][0][p], raster_runs[s][1][p]
    dw, attrs = CHAINS[s][p]
    jz, jg = np.asarray(jz), np.asarray(jg)
    assert pg.shape == jg.shape == (RG.N_CH, HP, WP) and pz.shape == jz.shape
    mat_same = pg[RG.CH_MAT] == jg[RG.CH_MAT]
    assert mat_same.mean() >= SAME_FRAC, mat_same.mean()
    assert (pg[RG.CH_COVER] == jg[RG.CH_COVER]).mean() >= SAME_FRAC
    assert (np.abs(pz - jz) <= Z_TOL).mean() >= SAME_FRAC
    assert (jg[RG.CH_MAT] >= 0).mean() > 0.3  # the pass draws
    if not dw:
        np.testing.assert_array_equal(pz, raster_runs[s][1][0][0])  # no depth write
    ok = mat_same & (jg[RG.CH_MAT] >= 0)
    np.testing.assert_allclose(pg[RG.CH_Z][ok], jg[RG.CH_Z][ok], rtol=1e-5, atol=1e-5)
    if attrs:
        # a plane (a*x + b*y) + c whose terms are large (|a x| up to a few
        # hundred) and cancel: allow 4 float32 ulps of the largest term too
        row = raster_runs["tabs"][p].tab.numpy()[jg[RG.CH_MAT][ok].astype(np.int64)]
        ys, xs = np.nonzero(ok)
        for ch in range(6):
            a, b, c = (row[:, RG.C_ATTR + 6 * k + ch] for k in range(3))
            terms = np.abs(a * (xs + 0.5)) + np.abs(b * (ys + 0.5)) + np.abs(c)
            err = np.abs(pg[RG.CH_UIW + ch][ok] - jg[RG.CH_UIW + ch][ok])
            bound = 1e-5 + 1e-5 * np.abs(jg[RG.CH_UIW + ch][ok]) + 2.0 ** -21 * terms
            assert (err <= bound).all(), (ch, float((err - bound).max()))
    # where nothing won, the port writes 0 in every channel but CH_MAT
    empty = pg[RG.CH_MAT] < 0
    assert (pg[RG.CH_MAT][empty] == -1).all()
    for ch in range(RG.N_CH):
        if ch != RG.CH_MAT:
            assert (pg[ch][empty] == 0).all()


@pytest.mark.parametrize("ch", [RG.CH_Z, RG.CH_UIW, RG.CH_IW])
def test_compare_raster_checks_drawn_channels(raster_runs, ch):
    """The kernel-against-twin check: a wrong z or attribute plane where a
    triangle won fails it; a change where nothing won is only reported."""
    z, g = (torch.as_tensor(x) for x in raster_runs[4][1][0])  # pass 0: depth + attributes
    res = ptesting.compare_raster(z, g, z, g)
    assert res["ok"] and res["max_abs_err"] == 0.0 and res["equal_frac"] == 1.0
    drawn, empty = (g[RG.CH_MAT] >= 0).nonzero(), (g[RG.CH_MAT] < 0).nonzero()
    bad = g.clone()
    bad[(ch, *drawn[len(drawn) // 2])] += 1e-3
    res = ptesting.compare_raster(z, bad, z, g)
    assert not res["ok"] and res["drawn_err"] == pytest.approx(1e-3, rel=1e-2)
    off = g.clone()
    off[(ch, *empty[0])] += 1.0
    res = ptesting.compare_raster(z, off, z, g)
    assert res["ok"] and res["max_abs_err"] == 1.0


@pytest.fixture(scope="module")
def shade_runs():
    """Stack shade with mips on and off, both packages, one JAX compile."""
    sh = ptesting.random_shade_inputs(5)
    stack = ptesting.random_stack(7, HP, WP, empty_tiles=((0, 0), (1, 1)), device="cpu")
    jlights = jpipe.make_lights(EngineConfig())
    jtabs = ST.ShadeTables(push_tab=jnp.zeros((1, 7)), knot_tab=jnp.asarray(sh["knot_tab"]),
                           tex_tab=jnp.asarray(sh["tex_tab"]),
                           edge_tab=jnp.asarray(sh["edge_tab"]),
                           atlas_flat=jnp.zeros((1, 4), jnp.uint8),
                           atlas_stride=sh["atlas_stride"])

    @jax.jit
    def ref(stack, knot, tex, edge, lights, eye, inv_vp):
        tabs = jtabs._replace(knot_tab=knot, tex_tab=tex, edge_tab=edge)
        return [ST.shade_stack_tpu(stack, tabs, lights, None, RIM, eye, inv_vp,
                                   interpret=True, use_mips=mips, lod_bias=(1.0, 0.0))
                for mips in (True, False)]

    jres = ref(jnp.asarray(stack.numpy()), jtabs.knot_tab, jtabs.tex_tab, jtabs.edge_tab,
               jlights, jnp.asarray(sh["eye_pos"]), jnp.asarray(sh["inv_vp"]))
    t = lambda k: torch.as_tensor(sh[k])  # noqa: E731
    ptabs = SG.ShadeTables(push_tab=torch.zeros((1, 7)), knot_tab=t("knot_tab"),
                           tex_tab=t("tex_tab"), edge_tab=t("edge_tab"),
                           atlas_stride=sh["atlas_stride"])
    plights = bridge.from_jax_arrays(jax.device_get(jlights), "cpu")
    pres = [SG.shade_stack(stack, ptabs, plights, RIM, t("eye_pos"), t("inv_vp"),
                           use_mips=mips, lod_bias=(1.0, 0.0)).numpy()
            for mips in (True, False)]
    return stack.numpy(), [np.asarray(r) for r in jres], pres


@pytest.mark.parametrize("mips", [True, False], ids=["mips", "no_mips"])
def test_shade_stack_matches(shade_runs, mips):
    stack, jres, pres = shade_runs
    o_ref, o_port = jres[1 - mips], pres[1 - mips]
    assert o_port.shape == o_ref.shape == (2 * SG.O_CH, HP, WP)
    res = ptesting.compare_shade(o_port, o_ref)
    assert res["ok"], (res["same_frac"], res["max_abs_err"])
    # an empty 32x128 tile of layer 0: index -1, zeros, a_eff copied
    tile = (slice(0, 32), slice(0, 128))
    assert (o_port[SG.O_TEX][tile] == -1).all()
    for ch in (SG.O_LR, SG.O_RIM, SG.O_DXDY, SG.O_FX):
        assert (o_port[ch][tile] == 0).all()
    np.testing.assert_array_equal(o_port[SG.O_AEFF], stack[SG.L_AEFF])
    np.testing.assert_array_equal(o_port[SG.O_CH + SG.O_AEFF], stack[SG.L_CH + SG.L_AEFF])
    # a shaded tile of layer 0 shades its empty pixels too
    assert (o_port[SG.O_LR][32:, :128] != 0).mean() > 0.9


def test_wrappers_use_twins_on_cpu():
    """On CPU tensors the wrappers run their twins; the launch counters only
    count kernel launches."""
    tabs = ptesting.random_raster_tables(11, (60,), 32, 128, device="cpu")[0]
    before = RG.raster_pass.launches
    za, ga = RG.raster_pass(tabs, torch.ones((4, 32, 128)), bx=1, depth_write=True)
    zb, gb = RG.raster_pass_twin(tabs, torch.ones((4, 32, 128)), bx=1, depth_write=True)
    assert torch.equal(za, zb) and torch.equal(ga, gb)
    assert RG.raster_pass.launches == before
    sh = ptesting.random_shade_inputs(5)
    t = lambda k: torch.as_tensor(sh[k])  # noqa: E731
    tables = SG.ShadeTables(push_tab=torch.zeros((1, 7)), knot_tab=t("knot_tab"),
                            tex_tab=t("tex_tab"), edge_tab=t("edge_tab"),
                            atlas_stride=sh["atlas_stride"])
    lights = bridge.from_jax_arrays(jax.device_get(jpipe.make_lights(EngineConfig())), "cpu")
    stack = ptesting.random_stack(7, 32, 128, device="cpu")
    before = SG.shade_stack.launches
    args = (stack, tables, lights, RIM, t("eye_pos"), t("inv_vp"))
    assert torch.equal(SG.shade_stack(*args, use_mips=True),
                       SG.shade_stack_twin(*args, use_mips=True))
    assert SG.shade_stack.launches == before
