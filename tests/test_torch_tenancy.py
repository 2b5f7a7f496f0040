"""Tenant adapters: the port's ``SubspacePlan.with_adapter``, the delta in
``bind.apply``, ``tenancy/{adapter,store,finetune,resident}.py``, the serve
engine's mixed-tenant mode and ``launch/finetune_user.py``, against the
reference on the same numpy inputs and the same weights (``api.bridge``).

qwen2 smoke is trained 40 steps in the port (the recipe of
``tests/test_torch_paged.py``, under ``wsi``) so that no greedy choice is
a near-tie that two summation orders could flip, and carried to the
reference's tree. The reference draws the three tenants' adapters once
per module (``init_adapters`` plus a constant offset, so La is nonzero,
as ``tests/test_tenancy.py``'s fixture does), and the port receives them
as numpy.

Tolerances:

* plan JSON, ``plan_sha``, tree specs, f32 store objects, gathers and
  the zero-init identity: exact;
* merged logits: rtol = atol = 2e-5, the f32 tolerance of
  ``tests/test_torch_lm.py`` (sums in another order);
* 4 ``finetune_adapters`` steps (SGD, momentum 0.9, lr 0.3, clip 2.0):
  per-step CE within 1e-5 relative, and each adapter leaf within 1e-5 of
  its scale (the SGD+momentum gate of ``tests/test_torch_train.py``);
* greedy tokens: exact. A mixed-tenant engine computes each slot's delta
  by a ``bmm`` pair on its gathered bank row, a solo engine over
  ``merge_adapters`` by the factored kernel's plain version: they round
  differently, and the trained weights keep every choice off a near-tie.
"""
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.serve as rserve
import repro.tenancy as rten
import repro.utils.memprof as rmem
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.tenancy as tten
from repro import api as rapi
from repro.checkpoint.ckpt import _tree_spec
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.tenancy.resident import ResidentAdapters as RResident
from repro_torch import api as tapi
from repro_torch.api import bind
from repro_torch.api.bridge import from_reference, to_reference
from repro_torch.checkpoint import save_checkpoint
from repro_torch.checkpoint.ckpt import _flatten as spec_of
from repro_torch.config import TrainConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import finetune_user as tfinetune_cli
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import ServeEngine
from repro_torch.serve.session import EventKind
from repro_torch.tenancy.adapter import tree_leaves, tree_map
from repro_torch.tenancy.resident import ResidentAdapters
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.memprof import adapter_bytes, model_weight_bytes

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
TENANTS = ["alice", "bob", "carol"]
MAX_NEW = 6
ENGINE_KW = dict(max_slots=4, max_cache=32, buckets=(4, 8, 16))
PAGED_KW = dict(paged=True, page_size=8, prefill_chunk=8)


def _torch_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The trained smoke base in both packages, the adapter-stamped plans,
    the reference's three tenant trees (and the port's copies), a store
    the PORT wrote holding each tenant f32 and int8 (``<t>.i8``), and
    prompts, three of which share an 8-token prefix."""
    cfg = tconfigs.get_smoke("qwen2-0.5b")
    rcfg = rconfigs.get_smoke("qwen2-0.5b")
    wcfg = cfg.replace(wasi=dataclasses.replace(cfg.wasi, method="wsi"))
    tapi.uninstall(wcfg)
    tapi.install(tapi.resolve(wcfg))
    tc = TrainConfig(optimizer="sgd", lr=0.3, momentum=0.9,
                     checkpoint_every=0)
    state = make_train_state(tlm.init_lm(wcfg, device="cpu", seed=0), wcfg,
                             tc)
    step = make_train_step(tlm.lm_loss, wcfg, tc)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                       seed=1)
    for i in range(40):
        state, _ = step(state, data.batch(i))
    tapi.uninstall(wcfg)
    rtree = to_reference(state.params)
    tapi.uninstall(cfg)
    plan = tapi.install(tapi.resolve(cfg))
    model = from_reference(rtree, cfg, "cpu")
    rapi.uninstall(rcfg)
    rplan = rapi.install(rapi.resolve(rcfg))
    rparams = jax.tree.map(jnp.asarray, rtree)
    raplan = rplan.with_adapter(0.25)
    rtrees = {}
    for i, t in enumerate(TENANTS):
        ad = rten.init_adapters(jax.random.PRNGKey(10 + i), rparams, raplan)
        rtrees[t] = jax.tree.map(lambda x, i=i: x + 0.01 * (i + 1), ad)
    ttrees = {t: _torch_tree(jax.tree.map(np.asarray, v))
              for t, v in rtrees.items()}
    aplan = plan.with_adapter(0.25)
    store = tten.AdapterStore(str(tmp_path_factory.mktemp("adapters")))
    for t in TENANTS:
        store.save(t, ttrees[t], aplan)
        store.save(f"{t}.i8", ttrees[t], aplan, fmt="int8")
    rng = np.random.default_rng(7)
    prefix = list(map(int, rng.integers(0, cfg.vocab_size, 8)))
    prompts = [prefix + list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in (2, 5, 9)]
    prompts += [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                for n in (7, 12)]
    yield types.SimpleNamespace(
        cfg=cfg, rcfg=rcfg, plan=plan, rplan=rplan, aplan=aplan,
        raplan=raplan, model=model, rtree=rtree, rparams=rparams,
        rtrees=rtrees, ttrees=ttrees, store=store, prompts=prompts)
    tapi.uninstall(cfg)
    rapi.uninstall(rcfg)


def _engine(world, model=None, **kw):
    return ServeEngine(model if model is not None else world.model,
                       world.cfg, device="cpu", **{**ENGINE_KW, **kw})


def _run(eng, prompts, tenants):
    hs = [eng.submit(p, max_new=MAX_NEW, tenant=t)
          for p, t in zip(prompts, tenants)]
    eng.run()
    assert all(h.finished and len(h.generated) == MAX_NEW for h in hs)
    return [h.generated for h in hs]


# ---------------------------------------------------------------------------
# plan stamps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,full", [("qwen2-0.5b", False),
                                       ("qwen2-0.5b", True),
                                       ("tinyllama-1.1b", True),
                                       ("zamba2-7b", True)])
def test_with_adapter_plan_matches_reference(arch, full):
    """Stamping the reference's plan (carried through its JSON) gives the
    reference's stamped JSON byte for byte under sort_keys, hence its
    ``plan_sha``. Each package's own resolve stamps the same ranks, and
    their JSON differs only in ``bwd_fits_vmem``, the TPU's VMEM fit rule
    the port leaves None (``api/plan.py``), so their shas differ.
    qwen2-0.5b's full ranks are 224 (q, o, MLP) and 32 (k, v)."""
    get_t = tconfigs.get if full else tconfigs.get_smoke
    get_r = rconfigs.get if full else rconfigs.get_smoke
    rbase = rapi.resolve(get_r(arch))
    rp = rbase.with_adapter(0.25)
    carried = tapi.SubspacePlan.from_json(rbase.to_json()).with_adapter(0.25)
    assert json.dumps(carried.to_json(), sort_keys=True) == \
        json.dumps(rp.to_json(), sort_keys=True)
    assert tten.plan_sha(carried) == rten.plan_sha(rp)
    tp = tapi.resolve(get_t(arch)).with_adapter(0.25)
    assert tp.has_adapters and rp.has_adapters
    tj, rj = tp.to_json(), rp.to_json()
    assert all(sp.pop("bwd_fits_vmem") is None for sp in tj["specs"])
    for sp in rj["specs"]:
        sp.pop("bwd_fits_vmem")
    assert tj == rj
    assert tten.adapter.adapter_site_ranks(tp) == \
        rten.adapter_site_ranks(rp)
    assert type(tp).from_json(tp.to_json()) == tp
    assert tp.summary().count(" adapter=") == len(tp.specs)
    if arch == "qwen2-0.5b" and full:
        assert tten.adapter.adapter_site_ranks(tp) == {
            "attn/wq": 224, "attn/wk": 32, "attn/wv": 32, "attn/wo": 224,
            "mlp/gate": 224, "mlp/up": 224, "mlp/down": 224}
    with pytest.raises(ValueError, match="rank fraction"):
        tp.with_adapter(0.0)


# ---------------------------------------------------------------------------
# trees, the delta, the merged forward
# ---------------------------------------------------------------------------

def test_adapter_trees_have_the_reference_structure(world):
    """``init_adapters``/``zero_adapters`` build the reference's tree (same
    on-disk spec, shapes and dtypes; La zeros, Ra at scale 0.02), from the
    model and from its plain tree alike."""
    g = torch.Generator().manual_seed(3)
    for src in (world.model, world.model.tree()):
        ad = tten.init_adapters(src, world.aplan, generator=g)
        leaves = []
        assert spec_of(tree_map(lambda t: t, ad), leaves) == \
            _tree_spec(world.rtrees["alice"], [0])
        want = jax.tree.leaves(world.rtrees["alice"])
        assert [tuple(t.shape) for t in leaves] == [w.shape for w in want]
        assert all(t.dtype == torch.float32 for t in leaves)
        pairs = list(bind.iter_adapter_dicts(ad))
        assert len(pairs) == 7 and all(not p["La"].any() for _, p in pairs)
        ra = torch.cat([p["Ra"].flatten() for _, p in pairs])
        assert 0.015 < ra.std().item() < 0.025
    zero = tten.zero_adapters(world.model, world.aplan)
    assert all(not t.any() for t in tree_leaves(zero))
    with pytest.raises(ValueError, match="no adapter stamps"):
        tten.init_adapters(world.model, world.plan, generator=g)


def test_zero_init_adapter_is_the_identity_exactly(world):
    """La = 0: the merged forward is the base's, bit for bit, for the
    merged model and the merged plain tree."""
    cfg = world.cfg
    ad = tten.init_adapters(world.model, world.aplan,
                            generator=torch.Generator().manual_seed(9))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)))
    base = tlm.lm_forward(world.model, toks, cfg)[0]
    for merged in (tten.merge_adapters(world.model, ad),
                   tten.merge_adapters(world.model.tree(), ad)):
        assert torch.equal(tlm.lm_forward(merged, toks, cfg)[0], base)


def test_merged_model_shares_the_base(world):
    """``merge_adapters`` on a model gives a model sharing every base leaf
    (the same Parameter objects), with frozen La/Ra beside them."""
    merged = tten.merge_adapters(world.model, world.ttrees["alice"])
    assert isinstance(merged, tlm.LanguageModel)
    held = {id(p) for p in world.model.parameters()}
    mine = list(merged.parameters())
    assert held <= {id(p) for p in mine}
    extra = [p for p in mine if id(p) not in held]
    assert len(extra) == 14 and not any(p.requires_grad for p in extra)
    assert model_weight_bytes(merged.tree())["adapter_bytes"] == \
        world.store.meta("alice")["bytes"]


@pytest.mark.parametrize("tenant", ["alice", "carol"])
def test_merged_logits_match_reference(world, tenant):
    """The same reference-made adapter arrays merged into the same
    weights: logits within f32 tolerance of the reference's merged
    forward; the delta is really there (away from the base's)."""
    cfg, rcfg = world.cfg, world.rcfg
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10))
    want = np.asarray(rlm.lm_forward(
        rten.merge_adapters(world.rparams, world.rtrees[tenant]),
        jnp.asarray(toks), rcfg)[0])
    merged = tten.merge_adapters(world.model, world.ttrees[tenant])
    got = tlm.lm_forward(merged, torch.from_numpy(toks), cfg)[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    base = tlm.lm_forward(world.model, torch.from_numpy(toks), cfg)[0]
    assert (got - base.numpy()).std() > 100 * TOL["atol"]


def test_gathered_rows_delta_matches_single_tenant_delta(world):
    """``stack_adapters`` + ``gather_rows`` equal the reference's on the
    same trees, and a batch whose rows carry different tenants' gathered
    factors (the bmm pair) gives each row its solo merged logits."""
    trees = [world.ttrees[t] for t in TENANTS]
    banks = tten.stack_adapters(trees)
    ix = torch.tensor([2, 0, 1])
    rbanks = rten.stack_adapters([world.rtrees[t] for t in TENANTS])
    rgot = rten.gather_rows(rbanks, jnp.asarray(ix.numpy()))
    got = tten.gather_rows(banks, ix)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(rgot)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cfg = world.cfg
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 9)))
    mixed = tlm.lm_forward(tten.merge_adapters(world.model.tree(), got),
                           toks, cfg)[0]
    for row, t in enumerate(ix.tolist()):
        solo = tlm.lm_forward(tten.merge_adapters(world.model, trees[t]),
                              toks[row:row + 1], cfg)[0]
        torch.testing.assert_close(mixed[row:row + 1], solo, **TOL)


def test_adapter_bytes_match_reference(world):
    """``adapter_bytes`` and the merged ``model_weight_bytes`` split: the
    reference's numbers, equal to the store's per-tenant bytes."""
    t = world.ttrees["bob"]
    rep = adapter_bytes(t, world.aplan)
    rrep = rmem.adapter_bytes(world.rtrees["bob"], world.raplan)
    assert rep["adapter_bytes"] == rrep["adapter_bytes"] == \
        world.store.meta("bob")["bytes"]
    assert rep["n_sites"] == rrep["n_sites"] == 7
    assert rep["by_site"] == rrep["by_site"]
    base = model_weight_bytes(world.model.tree())
    merged = model_weight_bytes(tten.merge_adapters(world.model, t).tree())
    rmerged = rmem.model_weight_bytes(
        rten.merge_adapters(world.rparams, world.rtrees["bob"]))
    assert base["adapter_bytes"] == 0
    assert merged == {k: rmerged[k] for k in merged}
    assert merged["total_bytes"] == base["total_bytes"] + rep["adapter_bytes"]
    with pytest.raises(ValueError, match="accounting"):
        adapter_bytes(world.model.tree(), world.aplan)


# ---------------------------------------------------------------------------
# the store, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_stores_cross_both_ways(world, fmt, tmp_path):
    """Each package reads the other's store, and writes the same metadata
    for the same tree and plan. f32: the same sha (the same object name),
    loads equal to the bit. int8: the port's packs are
    bit-equal to the reference's here (``quantize_tensor``'s absmax, one
    f32 division and round-half-even in both), so the sha is equal too;
    the dequantized loads agree to the bit and lie within half a
    quantization step of the f32 tree."""
    tstore = tten.AdapterStore(str(tmp_path / "port"))
    rstore = rten.AdapterStore(str(tmp_path / "reference"))
    # the reference's plan, carried: the metadata then agrees to the byte
    aplan = tapi.SubspacePlan.from_json(world.raplan.to_json())
    tm = tstore.save("alice", world.ttrees["alice"], aplan, fmt=fmt)
    rm = rstore.save("alice", world.rtrees["alice"], world.raplan, fmt=fmt)
    assert tm["object"] == rm["object"]
    assert {k: tm[k] for k in tm} == {k: rm[k] for k in tm}
    for reader, path in ((rten.AdapterStore, tstore.root),
                         (tten.AdapterStore, rstore.root)):
        tree, meta = reader(path).load("alice",
                                       expect_plan_sha=tm["plan_sha"])
        got = [np.asarray(x) for x in (tree_leaves(tree)
                                       if reader is tten.AdapterStore
                                       else jax.tree.leaves(tree))]
        want = [np.asarray(x) for x in jax.tree.leaves(world.rtrees["alice"])]
        assert all(g.dtype == np.float32 for g in got)
        for g, w in zip(got, want):
            if fmt == "f32":
                np.testing.assert_array_equal(g, w)
            else:
                step = np.abs(w).max(axis=-1, keepdims=True) / 127
                assert (np.abs(g - w) <= 0.5 * step * (1 + 1e-6)).all()
    if fmt == "int8":
        assert tm["bytes"] < world.store.meta("alice")["bytes"]


def test_store_dedupe_listing_and_guards(world):
    """Identical trees share one object; listing and byte accounting; the
    refusals: an unstamped plan, a bad tenant id, another plan's sha."""
    store = world.store
    before = store.total_object_bytes()
    m = store.save("alice-twin", world.ttrees["alice"], world.aplan)
    assert m["object"] == store.meta("alice")["object"]
    assert store.total_object_bytes() == before
    assert "alice-twin" in store.tenants() and store.has("alice-twin")
    assert store.bytes_by_tenant()["alice-twin"] == m["bytes"]
    assert not store.has("../x") and not store.has("nobody")
    with pytest.raises(ValueError, match="no adapter stamps"):
        store.save("zed", world.ttrees["alice"], world.plan)
    with pytest.raises(ValueError, match="bad tenant id"):
        store.save("a/b", world.ttrees["alice"], world.aplan)
    with pytest.raises(ValueError, match="unknown adapter format"):
        store.save("zed", world.ttrees["alice"], world.aplan, fmt="int4")
    with pytest.raises(ValueError, match="refusing"):
        store.load("alice", expect_plan_sha="0" * 64)
    os.remove(store._meta_path("alice-twin"))


# ---------------------------------------------------------------------------
# freeze-base fine-tuning
# ---------------------------------------------------------------------------

class _Batches:
    """The reference's batches, handed across as numpy."""

    def __init__(self, data):
        self.data = data

    def batch(self, step, batch_size=None):
        return {k: np.array(v) for k, v in
                self.data.batch(step, batch_size).items()}


def test_finetune_matches_reference(world):
    """4 steps from the same init on the same batches: per-step CE and the
    trained adapters within the module's tolerances of the reference's
    ``finetune_adapters``; the base's leaves are unchanged to the bit and
    the trainable state is the adapter tree alone."""
    cfg, rcfg = world.cfg, world.rcfg
    data = RSyntheticLM(vocab_size=rcfg.vocab_size, seq_len=16,
                        global_batch=4, seed=5).for_tenant("alice")
    init = rten.init_adapters(jax.random.PRNGKey(4), world.rparams,
                              world.raplan)
    rad, rmet = rten.finetune_adapters(world.rparams, world.raplan, data,
                                       steps=4, adapters=init)
    before = [p.clone() for p in world.model.parameters()]
    tad, tmet = tten.finetune_adapters(
        world.model, world.aplan, _Batches(data), steps=4,
        adapters=_torch_tree(jax.tree.map(np.asarray, init)))
    assert all(torch.equal(a, b)
               for a, b in zip(before, world.model.parameters()))
    assert abs(tmet["ce"] - rmet["ce"]) <= 1e-5 * abs(rmet["ce"])
    assert abs(tmet["grad_norm"] - rmet["grad_norm"]) <= \
        1e-5 * rmet["grad_norm"]
    moved = 0
    for g, w in zip(tree_leaves(tad), jax.tree.leaves(rad)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
        moved += int(np.abs(w).max() > 0)
    assert moved == 14                     # every La left its zero init
    assert all(not t.requires_grad for t in tree_leaves(tad))


def test_finetune_gradients_reach_only_the_adapters(world):
    """The adapter loss differentiates into La/Ra leaves only, every La's
    gradient is live at zero init, and a trainable base is read through
    frozen aliases of its storage (the reference's stop_gradient)."""
    cfg = world.cfg
    ad = tten.finetune.AdapterModule(tten.init_adapters(
        world.model, world.aplan, generator=torch.Generator().manual_seed(4)))
    trainable = from_reference(world.rtree, cfg, "cpu", trainable=True)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=2, seed=6).batch(0)
    loss = tten.adapter_loss_fn(trainable)(ad, batch, cfg)[0]
    names = [n for n, _ in ad.named_parameters()]
    grads = torch.autograd.grad(loss, list(ad.parameters()))
    assert len(names) == 14 and all(n[-2:] in ("La", "Ra") for n in names)
    assert all(torch.isfinite(g).all() for g in grads)
    assert all(g.any() for n, g in zip(names, grads) if n.endswith("La"))
    assert all(p.grad is None for p in trainable.parameters())


def test_finetune_beats_the_frozen_base_on_a_tenant_stream(world):
    """The reference's acceptance bar: 30 steps on a tenant's skewed
    stream beat the frozen base's CE on held-out batches of it."""
    cfg = world.cfg
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
                       seed=5).for_tenant("alice")
    ad, metrics = tten.finetune_adapters(world.model, world.aplan, data,
                                         steps=30)
    assert np.isfinite(metrics["ce"])
    assert tten.eval_ce(tten.merge_adapters(world.model, ad), cfg, data) \
        < tten.eval_ce(world.model, cfg, data)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals(world):
    """A quantized plan, an unstamped plan, unknown tenants, a tenant on
    an engine without banks, speculative decoding with adapters, another
    model's store, and a mesh: the reference's errors."""
    data = SyntheticLM(vocab_size=world.cfg.vocab_size, seq_len=16,
                       global_batch=2, seed=0)
    with pytest.raises(ValueError, match="f32 master"):
        tten.finetune_adapters(world.model, world.aplan.quantized(), data,
                               steps=1)
    eng = _engine(world, adapters=ResidentAdapters(world.store, capacity=2,
                                                   device="cpu"))
    with pytest.raises(ValueError, match="unknown tenant"):
        eng.submit(world.prompts[0], max_new=2, tenant="nobody")
    with pytest.raises(ValueError, match="no adapter banks"):
        _engine(world).submit(world.prompts[0], max_new=2, tenant="alice")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(world, spec_k=2, draft="rank:0.5",
                adapters=ResidentAdapters(world.store, capacity=2,
                                          device="cpu"))
    tapi.uninstall(world.cfg)
    try:
        with pytest.raises(NotImplementedError, match="mesh"):
            _engine(world, mesh=object(), adapters=world.store.root)
    finally:
        tapi.uninstall(world.cfg)
        tapi.install(world.plan)
    other = tconfigs.get_smoke("tinyllama-1.1b")
    tapi.uninstall(other)
    try:
        tapi.install(tapi.resolve(other))
        with pytest.raises(ValueError, match="trained for model"):
            ServeEngine(tlm.init_lm(other, device="cpu", seed=0), other,
                        device="cpu", max_slots=2, max_cache=16,
                        adapters=ResidentAdapters(world.store, device="cpu"))
    finally:
        tapi.uninstall(other)
    with pytest.raises(ValueError, match="capacity"):
        ResidentAdapters(world.store, capacity=0, device="cpu")


def test_bf16_model_with_f32_adapters_is_refused_as_the_reference_fails(
        world, tmp_path):
    """The reference cannot run f32 adapters on a bf16 model: its layer
    scan refuses the f32 carry the delta makes (shown here). The port
    refuses the same pairing before any forward, in ``merge_adapters`` and
    in ``ServeEngine(adapters=)``, naming the clash."""
    rcfg = world.rcfg.replace(dtype="bfloat16")
    rapi.uninstall(rcfg)
    rplan = rapi.install(rapi.resolve(rcfg))
    try:
        rp = rlm.init_lm(jax.random.PRNGKey(0), rcfg, jnp.bfloat16)
        rad = rten.init_adapters(jax.random.PRNGKey(1), rp,
                                 rplan.with_adapter(0.25))
        with pytest.raises(TypeError, match="carry"):
            rlm.lm_forward(rten.merge_adapters(rp, rad),
                           jnp.zeros((1, 4), jnp.int32), rcfg)
    finally:
        rapi.uninstall(rcfg)
    cfg = world.cfg.replace(dtype="bfloat16")
    tapi.uninstall(cfg)
    plan = tapi.install(tapi.resolve(cfg))
    try:
        model = tlm.init_lm(cfg, device="cpu", seed=0)
        aplan = plan.with_adapter(0.25)
        ad = tten.init_adapters(model, aplan,
                                generator=torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="clashes with the model's "
                                             "torch.bfloat16"):
            tten.merge_adapters(model, ad)
        store = tten.AdapterStore(str(tmp_path))
        store.save("t", ad, aplan)
        with pytest.raises(ValueError, match="clashes"):
            ServeEngine(model, cfg, device="cpu", max_slots=2, max_cache=16,
                        adapters=ResidentAdapters(store, device="cpu"))
    finally:
        tapi.uninstall(cfg)


# ---------------------------------------------------------------------------
# mixed-tenant serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("suffix", ["", ".i8"])
def test_mixed_tenant_engine_equals_solo_engines(world, paged, suffix):
    """One engine serving [alice, bob, carol, base, alice] in one batch
    emits, per request, what a solo engine over ``merge_adapters(model,
    tree)`` emits (the tree as the store loads it: dequantized for int8),
    and the base request what an engine with no adapters emits; paged, the
    prefix the first three share is hit only within a tenant's namespace
    (the fifth request repeats alice's prefix)."""
    kw = PAGED_KW if paged else {}
    assign = [t + suffix for t in TENANTS] + [None, "alice" + suffix]
    mixed = _engine(world, adapters=ResidentAdapters(world.store, capacity=3,
                                                     device="cpu"), **kw)
    prompts = world.prompts[:3] + world.prompts[3:4] + world.prompts[:1]
    got = _run(mixed, prompts, assign)
    assert sorted(mixed.adapters.resident()) == sorted(set(assign) - {None})
    for i, t in enumerate(assign):
        if t is None:
            want = _run(_engine(world, **kw), [prompts[i]], [None])
        else:
            tree, _ = world.store.load(t)
            solo = _engine(world, tten.merge_adapters(world.model, tree),
                           **kw)
            want = _run(solo, [prompts[i]], [None])
        assert got[i] == want[0], (t, i)
    if paged:
        # 8 shared tokens = 1 page; only alice's repeat finds its own
        # namespace's page, and only after alice's first prefill published
        assert mixed.stats["prefix_hit_tokens"] == 8
        mixed.release_prefix_cache()
        mixed.check_invariants()


def test_mixed_engine_matches_reference_engine_on_a_port_store(world):
    """The reference's mixed-tenant engine over the store the port wrote
    gives the port's tokens (dense, greedy) and the same tenancy
    counters."""
    assign = TENANTS + [None]
    reng = rserve.ServeEngine(world.rparams, world.rcfg, **ENGINE_KW,
                              adapters=world.store.root, adapter_slots=3)
    teng = _engine(world, adapters=ResidentAdapters(world.store, capacity=3,
                                                    device="cpu"))
    prompts = world.prompts[:4]
    want = _run(reng, prompts, assign)
    got = _run(teng, prompts, assign)
    assert got == want
    keys = ("capacity", "resident", "bank_bytes", "hits", "swaps",
            "evictions")
    rs, ts = reng.summary()["tenancy"], teng.summary()["tenancy"]
    assert {k: ts[k] for k in keys} == {k: rs[k] for k in keys}


def test_lru_churn_past_capacity(world):
    """Six tenant visits through a TWO-row bank in one slot: revisits
    emit what they emitted before, evictions fire as EVICTED events (rid
    -1) and stats, and the banks keep their storage throughout."""
    ra = ResidentAdapters(world.store, capacity=2, device="cpu")
    eng = _engine(world, max_slots=1, adapters=ra)
    ptrs = [t.data_ptr() for t in tree_leaves(ra.banks)]
    prompt = world.prompts[3]
    rotation = [None, "alice", "bob", "carol", "alice.i8", None, "carol",
                "alice"]
    outs = {}
    for t in rotation:
        out = _run(eng, [prompt], [t])[0]
        assert outs.setdefault(t, out) == out, t
    assert [t.data_ptr() for t in tree_leaves(ra.banks)] == ptrs
    # LRU: carol evicts alice, alice.i8 evicts bob, carol's revisit hits,
    # alice evicts alice.i8
    assert eng.stats["adapter_evictions"] == ra.evictions == 3
    assert ra.swaps == 5 and ra.hits == 1
    assert {e.kind for e in eng.adapter_events} == {EventKind.EVICTED}
    assert all(e.rid == -1 and "adapter lru" in e.reason
               for e in eng.adapter_events)
    assert [e.reason.split("=")[1] for e in eng.adapter_events] == \
        ["alice", "bob", "alice.i8"]


def test_pinned_rows_defer_and_drop_zeroes(world):
    """Two slots, ONE bank row: the second tenant finds the row pinned by
    the first's running request and waits (``deferred``); both finish
    with their solo tokens. ``acquire`` returns None when every row is
    pinned, and ``drop`` zeroes a row."""
    ra = ResidentAdapters(world.store, capacity=1, device="cpu")
    eng = _engine(world, max_slots=2, adapters=ra)
    got = _run(eng, world.prompts[3:5], ["alice", "bob"])
    assert eng.stats["deferred"] >= 1
    assert ra.evictions == 1 and ra.resident() == ["bob"]
    for out, t, p in zip(got, ("alice", "bob"), world.prompts[3:5]):
        solo = ServeEngine(tten.merge_adapters(world.model,
                                               world.store.load(t)[0]),
                           world.cfg, device="cpu", **ENGINE_KW)
        assert _run(solo, [p], [None])[0] == out
    assert ra.acquire("carol", pinned={1}) is None
    assert ra.acquire("bob", pinned={1}) == 1           # a hit needs no row
    ra.drop("bob")
    assert ra.resident() == [] and all(
        not t[..., 1, :, :].any() for t in tree_leaves(ra.banks))
    ra.drop("bob")                                      # unknown: no-op


def test_summary_reports_tenancy(world):
    eng = _engine(world, adapters=world.store.root, adapter_slots=2)
    _run(eng, world.prompts[1:2], ["bob"])
    s = eng.summary()
    t = s["tenancy"]
    assert t["resident"] == ["bob"] and t["capacity"] == 2
    assert t["swaps"] == 1 and t["evictions"] == 0
    assert s["adapter_bank_bytes"] == t["bank_bytes"] == \
        3 * world.store.meta("bob")["bytes"]
    assert t["bytes_by_tenant"]["bob"] == world.store.meta("bob")["bytes"]
    assert t["store_tenants"] == len(world.store.tenants())
    assert s["adapter_evictions"] == 0
    assert "tenancy" not in _engine(world).summary()


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_finetune_user_cli_check_on_cpu(world, tmp_path, capsys):
    """``launch/finetune_user.py --device cpu --check`` on a smoke
    checkpoint: the adapter beats the frozen base, the store holds it, and
    the serve launcher serves it through ``--adapters/--tenants``."""
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 40, world.model, plan=world.plan, label="params")
    store = str(tmp_path / "store")
    out = tfinetune_cli.main(["--ckpt", ckpt, "--tenant", "dana", "--store",
                              store, "--steps", "30", "--device", "cpu",
                              "--check", "--quant", "int8"])
    assert out["adapter_ce"] < out["base_ce"]
    assert out["meta"]["format"] == "int8"
    assert tten.AdapterStore(store).tenants() == ["dana"]
    printed = capsys.readouterr().out
    assert "[finetune_user] base_ce=" in printed
    with pytest.raises(SystemExit, match="only 'synthetic'"):
        tfinetune_cli.main(["--ckpt", ckpt, "--tenant", "dana", "--store",
                            store, "--data", "text:x", "--device", "cpu"])
    tapi.uninstall(world.cfg)
    try:
        s = tlaunch.main(["--ckpt", ckpt, "--device", "cpu", "--batch", "3",
                          "--max-slots", "2", "--tokens", "4", "--adapters",
                          store, "--tenants", "dana,", "--adapter-slots",
                          "1"])
    finally:
        tapi.uninstall(world.cfg)
        tapi.install(world.plan)
    assert s["tenancy"]["resident"] == ["dana"]
    assert "[serve] tenancy resident=dana" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--tenants needs --adapters"):
        tlaunch.main(["--device", "cpu", "--tenants", "dana"])
