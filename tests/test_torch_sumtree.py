"""The port's sum-tree descent and PER buffer against the JAX package.

On the CPU, ``freerl_tpu_torch.ops.sumtree.sumtree_descend`` runs its plain
twin, which must equal the JAX Pallas kernel (interpret mode) and its XLA
reference bit for bit: the descent only compares and subtracts in f32.
Tests marked ``gpu`` hold the CUDA kernel against the twin on the card and
skip without one. JAX is imported inside the CPU tests only, so the ``gpu``
tests also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sumtree.py
"""
import numpy as np
import pytest
import torch

from freerl_tpu_torch.buffers.per import PERBuffer, last_occurrence, search_left
from freerl_tpu_torch.core.types import Transition
from freerl_tpu_torch.ops import sumtree

torch.set_num_threads(1)


def _build_tree(cap, seed=0, spike_leaf=None, empty_half=False):
    """numpy sum-tree, built as tests/test_pallas_ops.py builds it; with
    ``empty_half`` the upper half of the leaves is zero (a half-filled
    buffer)."""
    depth = cap.bit_length() - 1
    rng = np.random.RandomState(seed)
    tree = np.zeros(2 * cap)
    tree[cap:] = rng.rand(cap)
    if empty_half:
        tree[cap + cap // 2:] = 0.0
    for lvl in range(depth - 1, -1, -1):
        lo, hi = 1 << lvl, 1 << (lvl + 1)
        tree[lo:hi] = tree[2 * lo: 2 * hi: 2] + tree[2 * lo + 1: 2 * hi: 2]
    tree = tree.astype(np.float32)
    if spike_leaf is not None:
        # spike one leaf, then re-sum in f32 as the JAX test's tree surgery
        tree[cap + spike_leaf] += np.float32(1000.0)
        for lvl in range(depth - 1, -1, -1):
            lo, hi = 1 << lvl, 1 << (lvl + 1)
            tree[lo:hi] = tree[2 * lo: 2 * hi: 2] + tree[2 * lo + 1: 2 * hi: 2]
    return tree, depth


def _stratified_u(tree, batch, seed):
    return ((np.arange(batch) + np.random.RandomState(seed).rand(batch))
            * float(tree[1]) / batch).astype(np.float32)


def _masses(tree, batch, kind, seed):
    """Stratified masses, all-zero masses, or masses at and above the root's
    total (the last one +inf when batch > 1): every step goes right there,
    and the final clip holds the index."""
    if kind == "stratified":
        return _stratified_u(tree, batch, seed)
    if kind == "zero":
        return np.zeros(batch, np.float32)
    u = (tree[1] * (1 + np.arange(batch) / batch)).astype(np.float32)
    if batch > 1:
        u[-1] = np.inf
    return u


# (tree, masses) of the edge cases: zero masses, masses at or above the
# total, and stratified masses over a tree whose upper half of leaves is zero
EDGE_CASES = [("uniform", "zero"), ("uniform", "over_total"),
              ("empty_half", "stratified"), ("empty_half", "over_total")]


@pytest.mark.parametrize("cap_pow", [8, 14, 17])
def test_twin_bit_equal_to_pallas_kernel(cap_pow):
    import jax.numpy as jnp

    from freerl_tpu.ops.sumtree_pallas import (sumtree_descend as jax_descend,
                                               sumtree_descend_xla)

    cap = 1 << cap_pow
    tree, depth = _build_tree(cap)
    u = _stratified_u(tree, 128, seed=1)
    ref_xla = np.asarray(sumtree_descend_xla(jnp.asarray(tree),
                                             jnp.asarray(u), depth, cap))
    ref_pallas = np.asarray(jax_descend(jnp.asarray(tree), jnp.asarray(u),
                                        depth, cap, interpret=True))
    before = sumtree.launches
    out = sumtree.sumtree_descend(torch.from_numpy(tree), torch.from_numpy(u),
                                  depth, cap)
    assert sumtree.launches == before     # CPU tensors never launch
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref_pallas)
    np.testing.assert_array_equal(out.numpy(), ref_xla)


@pytest.mark.parametrize("cap_pow", [3, 13])
@pytest.mark.parametrize("tree_kind,mass_kind", EDGE_CASES)
def test_twin_bit_equal_to_pallas_edge_cases(cap_pow, tree_kind, mass_kind):
    """The semantics the kernel is held to on the card, pinned on the CPU:
    the twin equals the Pallas kernel (interpret mode) and the XLA loop."""
    import jax.numpy as jnp

    from freerl_tpu.ops.sumtree_pallas import (sumtree_descend as jax_descend,
                                               sumtree_descend_xla)

    cap = 1 << cap_pow
    tree, depth = _build_tree(cap, seed=cap_pow,
                              empty_half=tree_kind == "empty_half")
    u = _masses(tree, 96, mass_kind, seed=3)
    ref_xla = np.asarray(sumtree_descend_xla(jnp.asarray(tree),
                                             jnp.asarray(u), depth, cap))
    ref_pallas = np.asarray(jax_descend(jnp.asarray(tree), jnp.asarray(u),
                                        depth, cap, interpret=True))
    out = sumtree.sumtree_descend(torch.from_numpy(tree), torch.from_numpy(u),
                                  depth, cap).numpy()
    np.testing.assert_array_equal(out, ref_pallas)
    np.testing.assert_array_equal(out, ref_xla)
    if mass_kind == "zero":
        assert (out == 0).all()               # never right of a zero-mass step
    elif mass_kind == "over_total":
        assert (out[1:] == cap - 1).all()     # above the total: rightmost leaf
    if tree_kind == "empty_half" and mass_kind == "stratified":
        assert (out < cap // 2).all()         # never an empty leaf


def test_twin_priority_spike():
    import jax.numpy as jnp

    from freerl_tpu.ops.sumtree_pallas import sumtree_descend as jax_descend

    cap = 1 << 12
    tree, depth = _build_tree(cap, spike_leaf=77)
    u = _stratified_u(tree, 512, seed=2)
    ref = np.asarray(jax_descend(jnp.asarray(tree), jnp.asarray(u), depth,
                                 cap, interpret=True))
    out = sumtree.sumtree_descend(torch.from_numpy(tree), torch.from_numpy(u),
                                  depth, cap).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out == 77).mean() > 0.2


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises; it never
    falls back to the twin."""
    tree = torch.empty(16, device="meta")
    u = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sumtree.sumtree_descend(tree, u, 3, 8)


def test_search_left_matches_searchsorted():
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    leaves = rng.rand(1000).astype(np.float32)
    leaves[rng.rand(1000) < 0.2] = 0.0            # flat runs in the cdf
    cdf = np.cumsum(leaves).astype(np.float32)
    u = np.concatenate([rng.rand(300).astype(np.float32) * cdf[-1] * 1.01,
                        cdf[rng.randint(0, 1000, 100)],   # exact hits
                        np.float32([0.0, -1.0])])
    got = search_left(torch.from_numpy(cdf), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(cdf, u, side="left"))
    np.testing.assert_array_equal(
        got, np.asarray(jnp.searchsorted(jnp.asarray(cdf), jnp.asarray(u),
                                         side="left")))


def test_last_occurrence_keeps_last_write():
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 20, 200)
    vals = rng.rand(200).astype(np.float32)
    s, v = last_occurrence(torch.from_numpy(idx), torch.from_numpy(vals))
    want = {}
    for i, x in zip(idx, vals):
        want[i] = x
    assert list(s.numpy()) == sorted(idx)
    for i, x in zip(s.numpy(), v.numpy()):
        assert x == want[i]


def _transitions(n, seed):
    rng = np.random.RandomState(seed)
    return dict(
        obs=rng.randn(n, 3).astype(np.float32),
        action=rng.randint(0, 4, n).astype(np.int32),
        reward=rng.randn(n).astype(np.float32),
        next_obs=rng.randn(n, 3).astype(np.float32),
        done=rng.rand(n) < 0.2,
        episode_done=rng.rand(n) < 0.3,
    )


@pytest.mark.parametrize("sampler", ["tree", "cumsum"])
def test_per_buffer_matches_jax(sampler):
    """Adds, a priority write with duplicate indices (the last write wins
    on both sides) and three stratified draws from the same uniforms."""
    import jax
    import jax.numpy as jnp

    from freerl_tpu.buffers.per import PERBuffer as JaxPER
    from freerl_tpu.core.types import Transition as JaxTransition

    first = {k: v[0] for k, v in _transitions(1, 0).items()}
    jbuf = JaxPER.create(200, JaxTransition(**jax.tree.map(jnp.asarray,
                                                           first)),
                         sampler=sampler)
    tbuf = PERBuffer.create(200, Transition(**{
        k: torch.as_tensor(v) for k, v in first.items()}), sampler=sampler)
    assert tbuf.capacity == jbuf.capacity == 256 and tbuf.depth == 8
    for i in range(5):
        b = _transitions(48, 10 + i)
        jbuf = jbuf.add(JaxTransition(**jax.tree.map(jnp.asarray, b)))
        tbuf.add(Transition(**{k: torch.as_tensor(v) for k, v in b.items()}))
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 240, 64).astype(np.int32)
    idx[::5] = 17                                  # duplicates
    td = (rng.randn(64) * 3).astype(np.float32)
    jbuf = jbuf.update_priorities(jnp.asarray(idx), jnp.asarray(td))
    tbuf.update_priorities(torch.from_numpy(idx), torch.from_numpy(td))
    np.testing.assert_allclose(tbuf.tree.numpy(), np.asarray(jbuf.tree),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tbuf.max_priority),
                               float(jbuf.max_priority), rtol=1e-6)
    for k in range(3):
        key = jax.random.PRNGKey(k)
        r = np.array(jax.random.uniform(key, (32,)))
        jbuf, jidx, jw = jbuf.sample_idx(key, 32)
        tidx, tw = tbuf.sample_idx(torch.from_numpy(r))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
        assert float(tbuf.beta) == float(jbuf.beta)
    batch = tbuf.gather(tidx)
    for name in ("obs", "action", "reward", "done"):
        np.testing.assert_array_equal(
            getattr(batch, name).numpy(),
            np.asarray(getattr(jbuf.gather(jidx), name)))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cap_pow", [0, 1, 3, 8, 13, 14, 17, 20, 21])
@pytest.mark.parametrize("batch", [1, 255, 256, 4096])
def test_kernel_bit_equal_to_twin(cuda, cap_pow, batch):
    """Every depth from 0 to 21 (multiples of the kernel's levels per round
    and not), partial warps, and the edge-case masses and trees."""
    cap = 1 << cap_pow
    for tree_kind, mass_kind in [("uniform", "stratified"), *EDGE_CASES]:
        tree, depth = _build_tree(cap, seed=cap_pow,
                                  empty_half=tree_kind == "empty_half")
        t = torch.from_numpy(tree).to(cuda)
        u = torch.from_numpy(_masses(tree, batch, mass_kind,
                                     seed=batch)).to(cuda)
        before = sumtree.launches
        out = sumtree.sumtree_descend(t, u, depth, cap)
        torch.cuda.synchronize()
        assert sumtree.launches == before + 1
        assert torch.equal(out, sumtree.sumtree_descend_ref(t, u, depth, cap)), \
            (tree_kind, mass_kind)


@pytest.mark.gpu
def test_kernel_priority_spike(cuda):
    cap = 1 << 12
    tree, depth = _build_tree(cap, spike_leaf=77)
    t = torch.from_numpy(tree).to(cuda)
    u = torch.from_numpy(_stratified_u(tree, 512, seed=2)).to(cuda)
    out = sumtree.sumtree_descend(t, u, depth, cap)
    assert torch.equal(out, sumtree.sumtree_descend_ref(t, u, depth, cap))
    assert float((out == 77).float().mean()) > 0.2


@pytest.mark.gpu
def test_kernel_rejects_bad_input(cuda):
    tree = torch.zeros(16, device=cuda)
    with pytest.raises(TypeError):
        sumtree.sumtree_descend(tree, torch.zeros(4, dtype=torch.float64,
                                                  device=cuda), 3, 8)
    with pytest.raises(ValueError):
        sumtree.sumtree_descend(tree, torch.zeros(4, device=cuda), 3, 6)
    with pytest.raises(ValueError):
        sumtree.sumtree_descend(torch.zeros(32, device=cuda)[::2],
                                torch.zeros(4, device=cuda), 3, 8)
    with pytest.raises(ValueError):
        sumtree.sumtree_descend(tree, torch.zeros(4, device="cpu"), 3, 8)
    with pytest.raises(ValueError):
        sumtree.sumtree_descend(tree, torch.zeros(2, 2, device=cuda), 3, 8)
