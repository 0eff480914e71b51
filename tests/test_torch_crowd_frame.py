"""The frame megakernel's crowd twin (``frame_gpu.render_megakernel_crowd``)
at C = 2 against the single-character twin run on each character (exact)
and against the JAX package's batched Pallas kernel in interpret mode
(``frame_tpu.render_megakernel`` with a leading character axis on its
tables, eye positions and inverse view-projections) on one 8x128 tile per
character, one sample and no mips (the batching, not the modes, is what
this file checks; ``test_torch_frame.py`` holds the modes to the
single-character kernel): the bounds of ``test_torch_frame.py``
(``testing.compare_shade``). A file of its own because the JAX batched
kernel's compile takes most of two minutes on a CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reze_tpu.kernels import frame_tpu as FT
from reze_tpu_torch import testing as ptesting
from reze_tpu_torch.kernels import frame_gpu as FG
from reze_tpu_torch.kernels import shade_gpu as SG
from test_torch_crowd import C, RIM, SEEDS, _eyes_inv_vps, _jlights, _jstack, _plights
from test_torch_frame import _jax_tables, _one_thread, _port_shade  # noqa: F401


@pytest.fixture(scope="module")
def frame_case():
    """C = 2 characters of seeded tables in one 8x128 tile: the crowd
    twin, the single twin per character and the JAX batched kernel."""
    sh = ptesting.random_shade_inputs(5)
    tabs = [ptesting.random_frame_tables(s, (60,) * 7, 8, 128, device="cpu") for s in SEEDS]
    crowd = ptesting.stack_tables(tabs)
    eyes, ivps = _eyes_inv_vps()
    kw = dict(hp=8, wp=128, n_samples=1, use_mips=False)
    args = (_port_shade(sh), _plights(), RIM)
    got = FG.render_megakernel_crowd(crowd, *args, torch.as_tensor(eyes),
                                     torch.as_tensor(ivps), **kw).numpy()
    single = [FG.render_megakernel_twin(tabs[c], *args, torch.as_tensor(eyes[c]),
                                        torch.as_tensor(ivps[c]), **kw).numpy()
              for c in range(C)]
    jt = [_jax_tables(t, sh) for t in tabs]
    jft = _jstack([x[0] for x in jt])
    ref = jax.jit(lambda jft, eye, ivp: FT.render_megakernel(
        jft, jt[0][1], _jlights(), RIM, eye, ivp, interpret=True, **kw))(
        jft, jnp.asarray(eyes), jnp.asarray(ivps))
    return crowd, got, single, np.asarray(ref)


def test_frame_crowd_twin_equals_single_twin(frame_case):
    crowd, got, single, _ = frame_case
    assert got.shape == (C, 2 * SG.O_CH, 8, 128)
    assert int(crowd.counts.sum()) > 0
    for c in range(C):
        np.testing.assert_array_equal(got[c], single[c])


@pytest.mark.parametrize("c", range(C))
def test_frame_crowd_twin_matches_pallas(frame_case, c):
    _, got, _, ref = frame_case
    res = ptesting.compare_shade(got[c], ref[c])
    assert res["ok"], (res["same_frac"], res["max_abs_err"])
    assert (ref[c][SG.O_CH + SG.O_AEFF] > 0).mean() > 0.25  # the character draws
