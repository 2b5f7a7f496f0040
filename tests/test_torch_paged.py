"""The paged KV pool: ``serve/kvpool.py``, the paged functions of
``nn/attention.py``, paged ``lm_prefill``/``lm_decode_step`` and the
engine's paged mode, against the reference on the same numpy inputs and
the same weights (``api.bridge``), and against the port's dense engine.

* kvpool: the reference's ``tests/test_kvpool.py`` cases and its refcount
  model, one parametrised test over both packages' ``kvpool``.
* Paged gathers and scatters copy values, so the pages they write are
  compared exactly, except the trash page 0: where a position lies past
  the page table (a dead row at ``pos == max_cache``, a chunk's padding
  past an ``n_hist``-sliced table) JAX drops the write and the port routes
  it to page 0, which nothing reads unmasked. Attention and logits are
  held at f32 tolerance (rtol = atol = 2e-5, ``tests/test_torch_lm.py``'s):
  the sums run in another order.
* The engine: the reference's fuzz harness (``tests/test_serve_fuzz.py``)
  at smoke size (page_size 8, prefill_chunk 8) for fcfs, spf and
  priority over prompts that share an 8-token prefix; greedy outputs must
  be prefixes of the port's dense engine's, token for token. As the
  reference's harness does, the weights are briefly trained (40 steps,
  here in the port, 0.7 s) so that no greedy choice is a near-tie that
  the two paths' rounding could flip.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.nn.attention as rattn
import repro.serve as rserve
import repro.serve.kvpool as rkv
import repro.utils.memprof as rmem
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.nn.attention as tattn
import repro_torch.serve.kvpool as tkv
from repro_torch import api as tapi
from repro_torch.api.bridge import from_reference, to_reference
from repro_torch.config import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import SamplingParams, ServeEngine
from repro_torch.serve.session import TERMINAL
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.memprof import kv_cache_bytes

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
MAX_CACHE, MAX_NEW_CAP, TICK_LIMIT = 32, 6, 400
PAGED_KW = dict(paged=True, page_size=8, prefill_chunk=8)
ENGINE_KW = dict(max_slots=2, max_cache=MAX_CACHE, buckets=(4, 8, 16))
KV = {"reference": rkv, "port": tkv}


@pytest.fixture(scope="module")
def world():
    """qwen2 smoke: weights trained 40 steps in the port, carried to the
    reference's tree; the prompt pool (three families sharing an 8-token
    prefix, page-aligned for page_size 8, and unshared strays needing 1-3
    chunks); the port's dense oracle for each prompt."""
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    rcfg = rconfigs.get_smoke("qwen2-0.5b")
    wcfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method="wsi"))
    tapi.uninstall(wcfg)
    tapi.install(tapi.resolve(wcfg))
    tcfg = TrainConfig(optimizer="sgd", lr=0.3, momentum=0.9,
                       checkpoint_every=0)
    state = make_train_state(tlm.init_lm(wcfg, device="cpu", seed=0), wcfg,
                             tcfg)
    step = make_train_step(tlm.lm_loss, wcfg, tcfg)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                       seed=1)
    for i in range(40):
        state, _ = step(state, data.batch(i))
    tapi.uninstall(wcfg)
    rparams = to_reference(state.params)
    model = from_reference(rparams, cfg, "cpu")
    rparams = jax.tree.map(jnp.asarray, rparams)

    rng = np.random.default_rng(42)
    prefix = list(map(int, rng.integers(0, cfg.vocab_size, 8)))
    prompts = [prefix + list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (2, 5, 12)]
    prompts += [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                for n in (3, 4, 7, 11, 16, 20)]
    dense = ServeEngine(model, cfg, device="cpu", **ENGINE_KW)
    hs = [dense.submit(p, max_new=MAX_NEW_CAP) for p in prompts]
    dense.run()
    oracle = [h.generated for h in hs]
    assert all(len(o) == MAX_NEW_CAP for o in oracle)
    return types.SimpleNamespace(cfg=cfg, rcfg=rcfg, model=model,
                                 rparams=rparams, prompts=prompts,
                                 oracle=oracle)


# ---------------------------------------------------------------------------
# kvpool: the reference's cases over both packages
# ---------------------------------------------------------------------------

def _pages_needed(kv):
    assert kv.pages_needed(1, 8) == 1
    assert kv.pages_needed(8, 8) == 1
    assert kv.pages_needed(9, 8) == 2
    assert kv.pages_needed(0, 8) == 0


def _pool_alloc_unref_cycle(kv):
    pool = kv.PagePool(6, 8)
    assert pool.usable_pages == 5 and pool.free_pages == 5
    a = pool.alloc(3)
    assert a is not None and len(set(a)) == 3 and kv.TRASH_PAGE not in a
    assert pool.pages_in_use == 3
    assert (pool.refs[a] == 1).all()
    pool.check()
    for p in a:
        pool.unref(p)
    assert pool.free_pages == 5 and pool.pages_in_use == 0
    pool.check()


def _pool_alloc_shortage_returns_none(kv):
    pool = kv.PagePool(4, 8)
    assert pool.alloc(4) is None          # only 3 usable (page 0 is trash)
    assert pool.free_pages == 3           # a failed alloc takes nothing
    assert pool.alloc(3) is not None
    assert pool.alloc(1) is None
    pool.check()


def _pool_refcount_sharing(kv):
    pool = kv.PagePool(4, 8)
    (p,) = pool.alloc(1)
    pool.ref(p)
    pool.unref(p)
    assert pool.free_pages == 2           # still held by the first holder
    pool.unref(p)
    assert pool.free_pages == 3
    pool.check()


def _pool_guards(kv):
    pool = kv.PagePool(4, 8)
    with pytest.raises(ValueError):
        pool.ref(kv.TRASH_PAGE)
    with pytest.raises(ValueError):
        pool.unref(kv.TRASH_PAGE)
    (p,) = pool.alloc(1)
    pool.unref(p)
    with pytest.raises(ValueError):
        pool.unref(p)                     # already free
    with pytest.raises(ValueError):
        kv.PagePool(1, 8)                 # no room for the trash page


def _radix_match_is_page_granular(kv):
    pool = kv.PagePool(10, 4)
    radix = kv.RadixCache(pool)
    prompt = list(range(10))              # 2 full pages + a 2-token tail
    pages = pool.alloc(3)
    assert radix.insert(prompt, pages) == 2       # tail page not published
    assert radix.match(prompt) == pages[:2]
    assert radix.match(prompt[:7]) == pages[:1]
    assert radix.match(prompt[:3]) == []
    assert radix.match([99] + prompt[1:]) == []
    assert pool.refs[pages[0]] == 2 and pool.refs[pages[2]] == 1


def _radix_first_writer_wins(kv):
    pool = kv.PagePool(10, 4)
    radix = kv.RadixCache(pool)
    a, b = pool.alloc(1), pool.alloc(1)
    radix.insert(list(range(4)), a)
    assert radix.insert(list(range(4)), b) == 0
    assert radix.match(list(range(4))) == a
    assert pool.refs[b[0]] == 1


def _radix_evict_lru_unreferenced_only(kv):
    pool = kv.PagePool(10, 2)
    radix = kv.RadixCache(pool)
    p1 = pool.alloc(2)
    radix.insert([0, 1, 2, 3], p1)
    p2 = pool.alloc(1)
    radix.insert([9, 8], p2)
    for p in p1 + p2:
        pool.unref(p)
    radix.match([9, 8])                   # freshen the second chain
    assert radix.evict(2) == 2            # p1's leaf, then its parent
    assert radix.match([0, 1, 2, 3]) == []
    assert radix.match([9, 8]) == p2
    pool.ref(p2[0])                       # a slot's ref pins the page
    assert radix.evict(1) == 0
    pool.unref(p2[0])
    assert radix.evict(1) == 1
    assert pool.pages_in_use == 0
    pool.check()


def _radix_clear_releases_everything(kv):
    pool = kv.PagePool(10, 2)
    radix = kv.RadixCache(pool)
    pages = pool.alloc(3)
    radix.insert([1, 2, 3, 4, 5, 6], pages)
    for p in pages:
        pool.unref(p)
    assert sorted(radix.held_pages()) == sorted(pages)
    assert radix.clear() == 3
    assert radix.held_pages() == [] and radix.n_nodes == 0
    assert pool.pages_in_use == 0
    pool.check()


def _radix_namespaces_are_apart(kv):
    pool = kv.PagePool(10, 2)
    radix = kv.RadixCache(pool)
    pages = pool.alloc(2)
    radix.insert([1, 2, 3, 4], pages, namespace="a")
    assert radix.match([1, 2, 3, 4], namespace="a") == pages
    assert radix.match([1, 2, 3, 4]) == []
    assert radix.match([1, 2, 3, 4], namespace="b") == []
    assert radix.n_nodes == 2 and sorted(radix.held_pages()) == \
        sorted(pages)


KV_CASES = [_pages_needed, _pool_alloc_unref_cycle,
            _pool_alloc_shortage_returns_none, _pool_refcount_sharing,
            _pool_guards, _radix_match_is_page_granular,
            _radix_first_writer_wins, _radix_evict_lru_unreferenced_only,
            _radix_clear_releases_everything, _radix_namespaces_are_apart]


@pytest.mark.parametrize("pkg", sorted(KV))
@pytest.mark.parametrize("case", KV_CASES, ids=lambda f: f.__name__[1:])
def test_kvpool_case(case, pkg):
    case(KV[pkg])


@pytest.mark.parametrize("pkg", sorted(KV))
@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.integers(0, 4)), max_size=40))
def test_pool_refcounts_match_reference_model(pkg, ops):
    """Random alloc/unref sequences against a plain-list model: refcounts,
    free count and ``check()`` agree at every step."""
    kv = KV[pkg]
    pool = kv.PagePool(9, 4)
    held: list[int] = []
    for is_alloc, n in ops:
        if is_alloc:
            got = pool.alloc(n)
            if got is None:
                assert pool.free_pages < n
            else:
                held.extend(got)
        elif held:
            pool.unref(held.pop(n % len(held)))
        pool.check()
        assert pool.pages_in_use == len(set(held))
    assert all(pool.refs[p] == held.count(p) for p in held)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.lists(st.integers(0, 3), min_size=1, max_size=12),
                min_size=1, max_size=5), st.integers(1, 3))
def test_radix_trees_of_both_packages_agree(prompts, page_size):
    """Any insert sequence gives the same pages, matches, refcounts and
    evictions in both packages."""
    pools = {k: kv.PagePool(64, page_size) for k, kv in KV.items()}
    trees = {k: KV[k].RadixCache(pools[k]) for k in KV}
    for prompt in prompts:
        got = {}
        for k in KV:
            pages = pools[k].alloc(KV[k].pages_needed(len(prompt),
                                                      page_size))
            got[k] = (pages, trees[k].insert(prompt, pages))
            for p in pages:
                pools[k].unref(p)
        assert got["port"] == got["reference"]
    for prompt in prompts:
        assert trees["port"].match(prompt) == trees["reference"].match(prompt)
    assert trees["port"].evict(3) == trees["reference"].evict(3)
    assert (pools["port"].refs == pools["reference"].refs).all()
    assert trees["port"].clear() == trees["reference"].clear()
    assert pools["port"].pages_in_use == 0


# ---------------------------------------------------------------------------
# paged functions against the reference
# ---------------------------------------------------------------------------

N_PAGES, PG, KVH, DH = 12, 8, 2, 16


def _pools(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N_PAGES, PG, KVH, DH)).astype(np.float32),
            rng.standard_normal((N_PAGES, PG, KVH, DH)).astype(np.float32))


def _caches(k, v):
    return (rattn.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
            tattn.PagedKVCache(k=torch.from_numpy(k.copy()),
                               v=torch.from_numpy(v.copy())))


def _same_pages(rcache, tcache, trash_differs: bool):
    """Every non-trash page equal to the bit; page 0 equal unless the
    case writes past the table (where JAX drops and the port writes
    trash)."""
    for r, t in ((rcache.k, tcache.k), (rcache.v, tcache.v)):
        r, t = np.asarray(r), t.numpy()
        np.testing.assert_array_equal(t[1:], r[1:])
        if not trash_differs:
            np.testing.assert_array_equal(t[0], r[0])


def test_paged_gather_matches_reference():
    k, _ = _pools(0)
    table = np.array([[3, 5, 1, 7], [0, 0, 0, 0], [2, 2, 9, 11]])
    got = tattn.paged_gather(torch.from_numpy(k), torch.from_numpy(table))
    want = rattn.paged_gather(jnp.asarray(k), jnp.asarray(table))
    assert got.shape == (3, 4 * PG, KVH, DH)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_update_decode_dead_row_at_max_cache():
    """Rows: live mid-page, live on the slot's last position, a dead row
    (all-trash table) at ``pos == max_cache``, and a row whose table is
    real but whose stale pos is ``max_cache``: its page index equals
    ``pages_per_slot``. The reference drops that write; the port sends it
    to page 0, never to the row's last page (a clamp would)."""
    k, v = _pools(1)
    rng = np.random.default_rng(2)
    table = np.array([[3, 5, 1, 7], [2, 6, 4, 8], [0, 0, 0, 0],
                      [9, 10, 11, 6]])
    max_cache = table.shape[1] * PG
    pos = np.array([13, max_cache - 1, max_cache, max_cache])
    kn = rng.standard_normal((4, 1, KVH, DH)).astype(np.float32)
    vn = rng.standard_normal((4, 1, KVH, DH)).astype(np.float32)
    rc, tc = _caches(k, v)
    rc = rattn.paged_update_decode(rc, jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(pos), jnp.asarray(table))
    out = tattn.paged_update_decode(tc, torch.from_numpy(kn),
                                    torch.from_numpy(vn),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(table))
    assert out is tc                      # in place
    _same_pages(rc, tc, trash_differs=True)
    np.testing.assert_array_equal(tc.k[6, PG - 1].numpy(), k[6, PG - 1])
    np.testing.assert_array_equal(tc.k[0, 0].numpy(), kn[3, 0])
    np.testing.assert_array_equal(tc.k[8, PG - 1].numpy(), kn[1, 0])


def test_paged_update_prefill_tail_past_nhist_table_goes_to_trash():
    """A (1, 16) chunk at offset 8 with 5 valid rows through a table cut
    to n_hist = 2 pages: rows 13-15 are padding inside the table, rows
    16-23 lie past it. Both land on page 0 only."""
    k, v = _pools(3)
    rng = np.random.default_rng(4)
    table = np.array([[4, 9]])
    kn = rng.standard_normal((1, 16, KVH, DH)).astype(np.float32)
    vn = rng.standard_normal((1, 16, KVH, DH)).astype(np.float32)
    off, vl = np.array([8]), np.array([5])
    rc, tc = _caches(k, v)
    rc = rattn.paged_update_prefill(rc, jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(off), jnp.asarray(table),
                                    valid_len=jnp.asarray(vl))
    tattn.paged_update_prefill(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                               torch.from_numpy(off), torch.from_numpy(table),
                               valid_len=torch.from_numpy(vl))
    _same_pages(rc, tc, trash_differs=False)
    np.testing.assert_array_equal(tc.k[9, :5].numpy(), kn[0, :5])
    np.testing.assert_array_equal(tc.k[9, 5:].numpy(), k[9, 5:])


def test_paged_update_prefill_valid_len_routes_to_page_zero():
    """Two rows at their own offsets, one valid row each shorter than the
    chunk: padded positions inside the table route to page 0."""
    k, v = _pools(5)
    rng = np.random.default_rng(6)
    table = np.array([[3, 5, 1, 7], [2, 6, 4, 8]])
    kn = rng.standard_normal((2, 8, KVH, DH)).astype(np.float32)
    vn = rng.standard_normal((2, 8, KVH, DH)).astype(np.float32)
    off, vl = np.array([4, 16]), np.array([8, 3])
    rc, tc = _caches(k, v)
    rc = rattn.paged_update_prefill(rc, jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(off), jnp.asarray(table),
                                    valid_len=jnp.asarray(vl))
    tattn.paged_update_prefill(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                               torch.from_numpy(off), torch.from_numpy(table),
                               valid_len=torch.from_numpy(vl))
    _same_pages(rc, tc, trash_differs=False)
    np.testing.assert_array_equal(tc.k[4, 3:].numpy(), k[4, 3:])


def test_paged_prefill_attention_matches_reference():
    k, v = _pools(7)
    rng = np.random.default_rng(8)
    table = np.array([[3, 5, 1, 7], [2, 6, 0, 0]])
    q = rng.standard_normal((2, 8, 4, DH)).astype(np.float32)
    qpos = np.array([[8 + i for i in range(8)], [3 + i for i in range(8)]])
    rc, tc = _caches(k, v)
    want = rattn.paged_prefill_attention(jnp.asarray(q), rc,
                                         jnp.asarray(table),
                                         jnp.asarray(qpos))
    got = tattn.paged_prefill_attention(torch.from_numpy(q), tc,
                                        torch.from_numpy(table),
                                        torch.from_numpy(qpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# model functions
# ---------------------------------------------------------------------------

def _layer0(world):
    """Layer 0's attention params: the port's view, the reference's
    slice."""
    tp = world.model.layer_views()[0][0][0]["attn"]
    rp = jax.tree.map(lambda a: a[0], world.rparams["groups"][0][0]["attn"])
    return tp, rp


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_apply_attention_paged_matches_reference(world, mode):
    cfg, rcfg = world.cfg, world.rcfg
    tp, rp = _layer0(world)
    kvh, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(9)
    pool = [rng.standard_normal((N_PAGES, PG, kvh, dh)).astype(np.float32)
            for _ in range(2)]
    table = np.array([[3, 5, 1, 7], [2, 6, 4, 8], [0, 0, 0, 0]])
    if mode == "prefill":
        sq = 8
        pos, vl = np.array([8, 0, 0]), np.array([8, 5, 1])
    else:
        sq = 1
        pos, vl = np.array([13, 30, 32]), None    # the dead row at max_cache
    x = rng.standard_normal((3, sq, cfg.d_model)).astype(np.float32)
    rc, tc = _caches(*pool)
    rout, rc, _ = rattn.apply_attention(
        rp, jnp.asarray(x), rcfg, cache=rc, pos=jnp.asarray(pos),
        valid_len=None if vl is None else jnp.asarray(vl),
        page_table=jnp.asarray(table))
    with torch.inference_mode():
        tout, tc2, _ = tattn.apply_attention(
            tp, torch.from_numpy(x), cfg, cache=tc, pos=torch.from_numpy(pos),
            valid_len=None if vl is None else torch.from_numpy(vl),
            page_table=torch.from_numpy(table))
    assert tc2 is tc
    # rows whose output means anything: a prefill row's valid positions
    # (padding attends over trash that duplicate writes raced for), and
    # the live decode rows (the dead row reads the trash page, where JAX
    # dropped its write and the port kept it)
    if mode == "prefill":
        keep = np.arange(sq)[None, :] < vl[:, None]
    else:
        keep = np.array([[True], [True], [False]])
    np.testing.assert_allclose(tout.numpy()[keep], np.asarray(rout)[keep],
                               **TOL)
    for r, t in ((rc.k, tc.k), (rc.v, tc.v)):
        np.testing.assert_allclose(t.numpy()[1:], np.asarray(r)[1:], **TOL)


def test_paged_attention_refuses_what_it_cannot_hold(world):
    cfg = world.cfg
    tp, _ = _layer0(world)
    cache = tattn.init_paged_cache(cfg, 4, PG, dtype=torch.float32,
                                   device="cpu")
    x = torch.zeros(1, 1, cfg.d_model)
    pos = torch.tensor([0])
    table = torch.zeros(1, 2, dtype=torch.long)
    with pytest.raises(ValueError, match="needs a page_table"):
        tattn.apply_attention(tp, x, cfg, cache=cache, pos=pos)
    for kw in (dict(window=4), dict(causal=False), dict(kv_memory=x)):
        with pytest.raises(ValueError, match="causal full attention only"):
            tattn.apply_attention(tp, x, cfg, cache=cache, pos=pos,
                                  page_table=table, **kw)


def _chunked_prefill(fn, model, cfg, caches, prompt, table, chunk, pg,
                     tensor):
    """The engine's chunk loop: (1, chunk) pieces at their offsets through
    the table cut to a power-of-2 history; returns the last chunk's
    logits."""
    cur = 0
    while cur < len(prompt):
        end = min(cur + chunk, len(prompt))
        toks = np.zeros((1, chunk), np.int64)
        toks[0, :end - cur] = prompt[cur:end]
        n_hist = min(table.shape[1],
                     1 << (rkv.pages_needed(end, pg) - 1).bit_length())
        logits, caches = fn(model, tensor(toks), cfg, caches=caches,
                            pos=tensor(np.array([cur])),
                            valid_len=tensor(np.array([end - cur])),
                            last_only=True,
                            page_table=tensor(table[:, :n_hist]))
        cur = end
    return logits, caches


def test_lm_chunked_prefill_and_paged_decode_match_reference(world):
    """A 21-token prompt in chunks of 8 (three calls, the last ragged)
    through page_size 4, then 3 teacher-forced decode steps: logits
    against the reference's, and against the port's dense engine path on
    the same history (one prefill, then dense decode). Decode reads chunk
    1's K/V, so a write through a copy of the stacked pool would show."""
    cfg, rcfg, model = world.cfg, world.rcfg, world.model
    pg, chunk, n_pages = 4, 8, 20
    rng = np.random.default_rng(10)
    prompt = list(map(int, rng.integers(0, cfg.vocab_size, 21)))
    nxt = rng.integers(0, cfg.vocab_size, 3)
    table = np.array([[7, 3, 12, 1, 9, 15, 2, 19]])     # 32 positions
    rcaches = rlm.init_lm_cache(rcfg, 1, 32, jnp.float32, pages=n_pages,
                                page_size=pg)
    rlog, rcaches = _chunked_prefill(rlm.lm_prefill, world.rparams, rcfg,
                                     rcaches, prompt, table, chunk, pg,
                                     jnp.asarray)
    want = [np.asarray(rlog[0, 0])]
    for i, t in enumerate(nxt):
        lg, rcaches = rlm.lm_decode_step(
            world.rparams, jnp.asarray([[t]]), rcaches,
            jnp.asarray([21 + i]), rcfg, page_table=jnp.asarray(table))
        want.append(np.asarray(lg[0]))
    with torch.inference_mode():
        tcaches = tlm.init_lm_cache(cfg, 1, 32, dtype=torch.float32,
                                    device="cpu", pages=n_pages,
                                    page_size=pg)
        leaves = [c["kv"].k for c in tcaches[0]]
        tlog, tcaches = _chunked_prefill(tlm.lm_prefill, model, cfg, tcaches,
                                         prompt, table, chunk, pg,
                                         torch.as_tensor)
        got = [tlog[0, 0].numpy()]
        for i, t in enumerate(nxt):
            lg, tcaches = tlm.lm_decode_step(
                model, torch.tensor([[int(t)]]), tcaches,
                torch.tensor([21 + i]), cfg,
                page_table=torch.from_numpy(table))
            got.append(lg[0].numpy())
        assert all(c["kv"].k is t for c, t in zip(tcaches[0], leaves))
        dcaches = tlm.init_lm_cache(cfg, 1, 32, dtype=torch.float32,
                                    device="cpu")
        dlog, dcaches = tlm.lm_prefill(model, torch.tensor([prompt]), cfg,
                                       caches=dcaches, last_only=True)
        dense = [dlog[0, 0].numpy()]
        for i, t in enumerate(nxt):
            lg, dcaches = tlm.lm_decode_step(model, torch.tensor([[int(t)]]),
                                             dcaches, torch.tensor([21 + i]),
                                             cfg)
            dense.append(lg[0].numpy())
    for g, w, d in zip(got, want, dense):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, d, **TOL)
    # the pools hold chunk 1's K/V in the table's first pages
    k0 = tcaches[0][0]["kv"].k.numpy()
    np.testing.assert_allclose(k0[:, table[0, :2]],
                               np.asarray(rcaches[0][0]["kv"].k)[
                                   :, table[0, :2]], **TOL)
    assert np.abs(k0[:, table[0, 0]]).max() > 0


def test_init_lm_cache_paged_layout_and_refusals():
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    c = tlm.init_lm_cache(cfg, 3, 40, dtype=torch.float32, device="cpu",
                          pages=11, page_size=4)
    kv = c[0][0]["kv"]
    assert isinstance(kv, tattn.PagedKVCache)
    assert kv.k.shape == (cfg.groups[0].repeat, 11, 4, cfg.n_kv_heads,
                          cfg.resolved_head_dim)
    assert tattn.PagedKVCache(k=kv.k[0], v=kv.v[0]).page_size == 4
    with pytest.raises(ValueError, match="together"):
        tlm.init_lm_cache(cfg, 3, 40, device="cpu", pages=11)
    for arch in ("gemma3-4b", "zamba2-7b", "falcon-mamba-7b"):
        with pytest.raises(ValueError, match="cannot use a paged KV cache"):
            tlm.init_lm_cache(tconfigs.get_smoke(arch), 1, 16, device="cpu",
                              pages=5, page_size=4)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_supports_paging_matches_reference(arch):
    for get in ("get", "get_smoke"):
        assert tlm.supports_paging(getattr(tconfigs, get)(arch)) == \
            rlm.supports_paging(getattr(rconfigs, get)(arch))


@pytest.mark.parametrize("arch,full,paged", [
    ("qwen2-0.5b", False, False), ("qwen2-0.5b", False, True),
    ("tinyllama-1.1b", True, False), ("tinyllama-1.1b", True, True)])
def test_kv_cache_bytes_matches_reference(arch, full, paged):
    get = "get" if full else "get_smoke"
    kw = dict(pages=4 * 32 + 1, page_size=16) if paged else {}
    got = kv_cache_bytes(getattr(tconfigs, get)(arch), 4, 512, **kw)
    assert got == rmem.kv_cache_bytes(getattr(rconfigs, get)(arch), 4, 512,
                                      **kw)
    assert got["mode"] == ("paged" if paged else "dense")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _run_scenario(world, eng, sched, seed, n_requests=4):
    """One seeded interleaving (the reference's harness): tick-scripted
    submits and cancels, driven to drain, ``check_invariants`` every 7
    ticks, then the audit."""
    rng = np.random.default_rng(seed)
    prompts, oracle = world.prompts, world.oracle
    live = []
    submitted = ticks = 0
    while submitted < n_requests or eng.busy:
        if submitted < n_requests and rng.random() < 0.6:
            i = int(rng.integers(len(prompts)))
            max_new = int(rng.integers(1, MAX_NEW_CAP + 1))
            eos_id = None
            if rng.random() < 0.25:       # eos on the oracle path: an early
                eos_id = oracle[i][int(rng.integers(max_new))]    # stop
            sp = SamplingParams(max_new=max_new, eos_id=eos_id)
            if sched == "priority":
                sp = SamplingParams(
                    max_new=max_new, eos_id=eos_id,
                    priority=int(rng.integers(0, 3)),
                    deadline_s=1e-6 if rng.random() < 0.125 else None)
            live.append((eng.submit(prompts[i], sampling=sp), i, max_new,
                         eos_id))
            submitted += 1
        if live and rng.random() < 0.12:
            h = live[int(rng.integers(len(live)))][0]
            if not h.done:
                eng.cancel(h.rid)
        eng.step()
        ticks += 1
        assert ticks < TICK_LIMIT, "engine failed to drain"
        if ticks % 7 == 0:
            eng.check_invariants()
    assert not eng.busy and all(s is None for s in eng.slots)
    eng.check_invariants()
    for h, i, max_new, eos_id in live:
        events = h.events
        assert sum(1 for e in events if e.kind in TERMINAL) == 1, h.rid
        assert events[-1].kind in TERMINAL
        gen = h.generated
        assert len(gen) <= max_new
        assert gen == oracle[i][:len(gen)], (h.rid, gen, oracle[i])
        if h.finished:
            if eos_id is None:
                assert len(gen) == max_new
            else:
                assert gen[-1] == eos_id or len(gen) == max_new
                assert eos_id not in gen[:-1]


@pytest.mark.parametrize("sched", ["fcfs", "spf", "priority"])
def test_fuzz_paged_interleavings(world, sched):
    eng = ServeEngine(world.model, world.cfg, device="cpu", scheduler=sched,
                      **ENGINE_KW, **PAGED_KW)
    base = {"fcfs": 0, "spf": 1000, "priority": 2000}[sched]
    n = 12
    for seed in range(n):
        _run_scenario(world, eng, sched, base + seed)
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.stats["completed"] + eng.stats["cancelled"] \
        + eng.stats["evicted"] == n * 4
    eng.release_prefix_cache()
    eng.check_invariants()
    assert eng.pool.pages_in_use == 0


def test_fuzz_paged_starved_pool(world):
    """A pool with barely more than one request's pages: admissions defer
    and radix pages are evicted under pressure, yet every interleaving
    drains with oracle-exact outputs."""
    eng = ServeEngine(world.model, world.cfg, device="cpu", total_pages=5,
                      **ENGINE_KW, **PAGED_KW)
    for seed in range(10):
        _run_scenario(world, eng, "fcfs", 200_000 + seed, n_requests=3)
    assert eng.stats["deferred"] > 0, "pool never under pressure"
    eng.release_prefix_cache()
    eng.check_invariants()
    assert eng.pool.pages_in_use == 0


def test_paged_engine_matches_reference_paged_engine(world):
    """Every prompt of the pool through two slots, greedy: the port's paged
    engine gives the reference's paged engine's tokens and counters."""
    reng = rserve.ServeEngine(world.rparams, world.rcfg, **ENGINE_KW,
                              **PAGED_KW)
    teng = ServeEngine(world.model, world.cfg, device="cpu", **ENGINE_KW,
                       **PAGED_KW)
    out = {}
    for name, eng in (("reference", reng), ("port", teng)):
        hs = [eng.submit(p, max_new=MAX_NEW_CAP) for p in world.prompts]
        eng.run()
        s = eng.summary()
        out[name] = ([h.generated for h in hs],
                     {k: s[k] for k in ("paged", "page_size", "total_pages",
                                        "pages_in_use", "prefix_cache_pages",
                                        "prefill_chunks", "prefix_hit_tokens",
                                        "deferred", "prefill_tokens",
                                        "decode_steps", "decode_tokens")})
    assert out["port"] == out["reference"]
    assert out["port"][0] == world.oracle
    assert out["port"][1]["prefix_hit_tokens"] > 0


def test_paged_sampled_request_equals_dense(world):
    """A seeded sampled request draws the same tokens paged and dense (the
    first token from the last chunk's logits, count 0)."""
    sp = SamplingParams(temperature=0.9, top_k=20, seed=77)
    toks = {}
    for paged in (False, True):
        kw = PAGED_KW if paged else {}
        eng = ServeEngine(world.model, world.cfg, device="cpu", **ENGINE_KW,
                          **kw)
        h = eng.submit(world.prompts[2], max_new=6, sampling=sp)
        eng.submit(world.prompts[0], max_new=4)
        eng.run()
        toks[paged] = h.generated
    assert toks[True] == toks[False] and len(set(toks[True])) > 1


@pytest.mark.parametrize("arch", ["gemma3-4b", "zamba2-7b",
                                  "falcon-mamba-7b"])
def test_paged_refused_where_the_reference_refuses(arch):
    """``paged=True`` raises the reference's error for configs with window
    or recurrent layers; ``paged="auto"`` serves them dense."""
    cfg = tconfigs.get_smoke(arch)
    model = tlm.init_lm(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="paged KV pool cannot hold"):
        ServeEngine(model, cfg, device="cpu", paged=True, **ENGINE_KW)
    eng = ServeEngine(model, cfg, device="cpu", paged="auto", **ENGINE_KW)
    assert not eng.paged and eng.summary()["paged"] is False
    h = eng.submit([1, 2, 3], max_new=3)
    eng.run()
    assert len(h.generated) == 3


def test_submit_refuses_more_pages_than_usable(world):
    """Total pages 4 (3 usable of page_size 8): a 20-token prompt with 6
    new tokens needs 4 pages; both packages refuse it with one message."""
    kw = dict(ENGINE_KW, total_pages=4, **PAGED_KW)
    reng = rserve.ServeEngine(world.rparams, world.rcfg, **kw)
    teng = ServeEngine(world.model, world.cfg, device="cpu", **kw)
    prompt = world.prompts[-1]
    with pytest.raises(ValueError) as re_:
        reng.submit(prompt, max_new=6)
    with pytest.raises(ValueError) as te_:
        teng.submit(prompt, max_new=6)
    assert str(te_.value) == str(re_.value)
    assert "usable" in str(te_.value)
    teng.submit(prompt[:10], max_new=6)                 # 2 pages: fits


def test_launcher_paged_on_cpu(capsys):
    s = tlaunch.main(["--paged", "--device", "cpu", "--batch", "5",
                      "--max-slots", "2", "--tokens", "6", "--page-size",
                      "8", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert " paged pg=8 pages=" in out and "chunks=" in out
    assert s["paged"] and s["completed"] == 5
    assert s["pages_in_use"] == s["prefix_cache_pages"]
