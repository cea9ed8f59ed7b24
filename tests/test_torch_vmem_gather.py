"""The window gather probe (K9) and its timing path against the JAX probe,
on the CPU.

``window_gather_plain`` and ``window_gather`` on CPU tensors are held to
the JAX probe's ``gather_kernel`` (``tools/exp_vmem_gather.py``) run in
Pallas interpret mode with ``run_probe``'s grid and block specs: both add
the same float32 terms in the same order, so the difference is exactly 0.
Also: ``timing.chain_ms`` feeds the state back, ``exp_vmem_gather.run_probe``
times the chained step on the CPU and refuses to run without a card when
no device is given, and ``exp_gather_chunk``'s gather sums agree with
numpy."""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lammps_user_conp2_tpu_torch import exp_gather_chunk, exp_vmem_gather
from lammps_user_conp2_tpu_torch.ops.kernels import vmem_gather
from lammps_user_conp2_tpu_torch.timing import chain_ms

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


@pytest.fixture
def jax_probe(monkeypatch):
    """tools/exp_vmem_gather.py, imported with tools/ on sys.path (it
    imports ``timing`` bare)."""
    monkeypatch.syspath_prepend(TOOLS)
    import exp_vmem_gather as probe
    return probe


def _jax_gather(probe, win, idx):
    nb, W, _ = win.shape
    spec = pl.BlockSpec((1, W, 128), lambda t: (t, 0, 0),
                        memory_space=pltpu.VMEM)
    f = pl.pallas_call(
        probe.gather_kernel, grid=(nb,), in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((nb, W, 128), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(win), jnp.asarray(idx)))


@pytest.mark.parametrize("nb,W,R", [(2, 16, 1), (2, 16, 3), (3, 64, 8),
                                    (1, 40, 5)])
def test_window_gather_matches_jax_kernel(jax_probe, monkeypatch, nb, W, R):
    monkeypatch.setattr(jax_probe, "R", R)
    rng = np.random.default_rng(nb * 1000 + W + R)
    win = rng.standard_normal((nb, W, 128)).astype(np.float32)
    idx = rng.integers(0, W, size=(nb, W, 128)).astype(np.int32)
    ref = _jax_gather(jax_probe, win, idx)
    assert ref.dtype == np.float32
    win_t, idx_t = torch.from_numpy(win), torch.from_numpy(idx)
    plain = vmem_gather.window_gather_plain(win_t, idx_t, R)
    wrapped = vmem_gather.window_gather(win_t, idx_t, R)
    assert plain.dtype == torch.float32 and plain.shape == (nb, W, 128)
    assert np.abs(plain.numpy() - ref).max() == 0.0
    assert np.abs(wrapped.numpy() - ref).max() == 0.0


def test_window_cols_fit_shared_memory():
    """The lanes of a work item: the widest of 16, 8, 4 whose window fits
    the shared memory once, up to the W whose window fills it at 4."""
    plans = [vmem_gather.window_plan(1, W, 132) for W in (16, 2048, 4096,
                                                           8192, 14336)]
    assert [p.cols for p in plans] == [16, 16, 8, 4, 4]
    assert all(p.nbox <= p.slots <= 2 * p.nbox for p in plans)
    assert all(p.smem <= vmem_gather.SMEM_LIMIT for p in plans)
    with pytest.raises(ValueError):
        vmem_gather.window_plan(1, 14337, 132)


def test_chain_ms_feeds_state_back():
    seen = []

    def fn(s):
        seen.append(float(s))
        return s + 1.0

    ms = chain_ms(fn, torch.zeros(()), iters=5, trials=2)
    assert seen == [float(i) for i in range(15)]
    assert math.isfinite(ms) and ms > 0.0


def test_run_probe_on_cpu(capsys):
    out = exp_vmem_gather.run_probe(2, 32, R=3, device="cpu", iters=2)
    assert out["R"] == 3 and math.isfinite(out["ms"]) and out["ms"] > 0.0
    assert out["ns_row"] == pytest.approx(out["ms"] * 1e6 / (2 * 3 * 32 * 32))
    assert out["ns_element"] == pytest.approx(out["ns_row"] / 4)
    assert "W=32 nb=2 R=3:" in capsys.readouterr().out
    # the probe's inputs are the JAX probe's (default_rng(0), float32/int32)
    win, idx = exp_vmem_gather.probe_inputs(2, 32, "cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        win.numpy(), rng.standard_normal((2, 32, 128)).astype(np.float32))
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, 32, size=(2, 32, 128)).astype(np.int32))


def test_probes_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_vmem_gather.run_probe(2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_gather_chunk.run(n=64, k=8)


@pytest.mark.parametrize("name", ["random", "local"])
def test_gather_chunk_sums_match_numpy(name):
    n, k = 96, 8
    tab_np, idx_sets = exp_gather_chunk.make_inputs(n, k)
    idx_np = idx_sets[name]
    assert idx_np.dtype == np.int32 and idx_np.shape == (n, k)
    assert idx_np.min() >= 0 and idx_np.max() < n
    if name == "local":
        off = (idx_np - np.arange(n)[:, None] + n // 2) % n - n // 2
        assert np.abs(off).max() <= 400
    ref = tab_np[idx_np.reshape(-1)].sum(axis=0)[None]
    tab = torch.as_tensor(tab_np)
    idx = torch.as_tensor(idx_np)
    got = exp_gather_chunk.gather_sum(tab, idx)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    # the 16-byte element gather takes float32 tables: the same rows, summed
    # by the same reduction, as indexing the float32 table
    tab32 = tab.float()
    assert torch.equal(exp_gather_chunk.gather_sum_rows(tab32, idx),
                       exp_gather_chunk.gather_sum(tab32, idx))
    with pytest.raises(ValueError):
        exp_gather_chunk.gather_sum_rows(tab, idx)
    for nchunk in exp_gather_chunk.CHUNKS:
        got = exp_gather_chunk.gather_sum_chunked(
            tab, idx.reshape(nchunk, n * k // nchunk))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_gather_chunk_run_on_cpu(capsys):
    out = exp_gather_chunk.run(n=64, k=8, device="cpu", iters=2)
    assert [(r["name"], r["chunks"], r["op"]) for r in out] == [
        (s, c, op) for s in ("random", "local")
        for c, op in ((1, "index"), (4, "index"), (8, "index"),
                      (16, "index"), (1, "elements"))]
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0.0 for r in out)
    assert all(r["ns_row"] == pytest.approx(r["ms"] * 1e6 / 512) for r in out)
    assert "one-shot" in capsys.readouterr().out
