"""The MoE family in the port (``nn/moe.py``, the ``moe`` and ``moe_swa``
kinds; mixtral-8x7b and deepseek-moe-16b) against the reference's
``repro.nn.moe`` and ``repro.models.lm`` on the same numpy inputs and the
same weights (``api.bridge``).

* Registry and plans: both configs resolve, field for field, to the
  reference's plan JSON (the TPU-only ``bwd_fits_vmem`` aside, as in
  ``tests/test_torch_plan.py``); mixtral has no ``mlp/*`` site;
  ``with_adapter`` leaves the expert sites unstamped.
* ``apply_moe`` (y, aux), with capacity that binds (dropped choices
  counted > 0) and capacity that does not; tied tokens (every token the
  same, so capacity order alone decides the drops) and tied experts (two
  router rows equal, so the top-k order at a tie decides the positions);
  each ``_bank_matmul`` branch (factored, dense, int8, project with the
  gradient on ``w`` and zero on ``L`` and ``R``). f32 on both sides, sums
  in other orders: outputs within 2e-5 (values of order 1); the integer
  parts (positions, drops) exact.
* Whole models: logits, ``lm_loss`` with its aux, and every gradient; 4
  train steps under ``wsi`` (a refresh over the expert banks every 2),
  ``wasi`` and project mode against the reference's jitted
  ``make_train_step``, at ``tests/test_torch_remat.py``'s tolerances.
* int8 packs (``convert.quantize``) equal to the reference's byte for byte,
  the router left f32 and unpacked; ``model_weight_bytes`` equal.
* Plan-bearing ``train_state`` checkpoints written by either package and
  read by the other, bit for bit, the router f32 in a bf16 model.
* Greedy engine tokens against the reference's engine: dense for both
  configs, paged for deepseek (which has no window); the launcher.
  Capacity groups are batch rows, and a bucketed prefill's pad tokens take
  capacity as in the reference, so each mode is held to the reference's
  engine in the same mode.

The reference's weights are drawn by the port (``init_lm``, milliseconds)
and carried across by ``api.bridge.to_reference``, once per file.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.nn.moe as rmoe
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.nn.moe as tmoe
from repro import api as rapi
from repro import serve as rserve
from repro.api import convert as rconvert
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.config import TrainConfig as RTrainConfig
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro_torch import api as tapi
from repro_torch.api import bind
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import (
    _module,
    _nest,
    from_reference,
    state_from_reference,
    state_to_reference,
    to_reference,
)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.config import TrainConfig
from repro_torch.kernels import ops
from repro_torch.serve import ServeEngine
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.memprof import model_weight_bytes

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
TOL = dict(rtol=2e-5, atol=2e-5)
B, S, STEPS = 4, 16, 4


def _with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _cfgs(arch, **moe):
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if moe:
        rcfg, tcfg = _with_moe(rcfg, **moe), _with_moe(tcfg, **moe)
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    return rcfg, tcfg


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# registry and plans
# ---------------------------------------------------------------------------

def _plan_json(plan):
    d = plan.to_json()
    for s in d["specs"]:
        s.pop("bwd_fits_vmem", None)
    return d


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_matches_reference(arch, full):
    get = "get" if full else "get_smoke"
    rcfg = getattr(rconfigs, get)(arch)
    tcfg = getattr(tconfigs, get)(arch)
    assert _plan_json(tapi.resolve(tcfg)) == _plan_json(rapi.resolve(rcfg))
    names = {s.name for s in tapi.resolve(tcfg).specs}
    assert {"moe/w_gate", "moe/w_up", "moe/w_down"} <= names
    has_mlp = any("dense" in g.pattern for g in tcfg.groups)
    assert ("mlp/up" in names) == has_mlp == (arch == "deepseek-moe-16b")
    if full and arch == "deepseek-moe-16b":
        assert tapi.resolve(tcfg).spec("moe/w_up").rank == 384


def test_registry_and_unported_arch():
    """The port's registry is the reference's, whisper-tiny included, in
    its order; a name neither package knows raises in both."""
    assert tconfigs.list_archs() == rconfigs.list_archs()
    for get in (tconfigs.get, rconfigs.get):
        with pytest.raises(KeyError, match="unknown arch"):
            get("whisper-small")


def test_with_adapter_leaves_moe_sites_unstamped():
    _, tcfg = _cfgs("deepseek-moe-16b")
    plan = tapi.resolve(tcfg).with_adapter()
    for s in plan.specs:
        assert bool(s.adapter) == (s.role != "moe"), s.name


# ---------------------------------------------------------------------------
# apply_moe and the bank products
# ---------------------------------------------------------------------------

@functools.cache
def _moe_params(arch):
    """The port's MoE layer weights (seed 3) and the reference's tree."""
    _, tcfg = _cfgs(arch)
    p = tmoe.init_moe(tcfg, generator=torch.Generator().manual_seed(3))
    return p, jax.tree.map(jnp.asarray, to_reference_tree(p))


def to_reference_tree(node):
    if isinstance(node, (dict, torch.nn.ModuleDict, torch.nn.ParameterDict)):
        return {k: to_reference_tree(v) for k, v in node.items()}
    return node.detach().numpy().copy()


# one compile per config and shape; the eager reference compiles op by op
_ref_apply = jax.jit(rmoe.apply_moe, static_argnums=(2,))


def _run_both(arch, x, p=None, rp=None, **moe):
    rcfg, tcfg = _cfgs(arch, **moe)
    if p is None:
        p, rp = _moe_params(arch)
    yr, ar = _ref_apply(rp, jnp.asarray(x), rcfg)
    yt, at = tmoe.apply_moe(p, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(yt), np.asarray(yr), **TOL)
    np.testing.assert_allclose(float(at), float(ar), rtol=1e-6)
    return tmoe.route(p, torch.from_numpy(x), tcfg)


def _ref_positions(rp, x, rcfg):
    """The reference's capacity positions, from its own expressions."""
    m = rcfg.moe
    logits = jnp.einsum("bsd,ed->bse", jnp.asarray(x), rp["router"]["w"])
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), m.top_k)
    b, s = x.shape[:2]
    flat = jax.nn.one_hot(top_e, m.n_experts, dtype=jnp.int32).reshape(
        b, s * m.top_k, m.n_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    return (np.asarray(top_e),
            np.asarray((pos * flat).sum(-1).reshape(b, s, m.top_k)))


@pytest.mark.parametrize("binds", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, binds):
    """capacity_factor 0.5 binds (choices dropped in every group), the
    smoke config's 2.0 does not here."""
    moe = dict(capacity_factor=0.5) if binds else {}
    rcfg, _ = _cfgs(arch, **moe)
    x = np.random.default_rng(1).standard_normal(
        (3, 32, rcfg.d_model)).astype(np.float32)
    *_, top_e, pos, fits = _run_both(arch, x, **moe)
    want_e, want_pos = _ref_positions(_moe_params(arch)[1], x, rcfg)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    dropped = int((~fits).sum())
    assert (dropped > 0) == binds, dropped
    if binds:
        assert bool((~fits).any(dim=(1, 2)).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_tokens_drop_by_capacity_order(arch):
    """Every token the same (``tests/test_moe.py``'s input): all choose the
    same experts, and the capacity positions alone decide which are
    dropped: the first ``C`` tokens keep each choice."""
    rcfg, _ = _cfgs(arch)
    x = np.full((2, 40, rcfg.d_model), 0.1, np.float32)
    x[1] *= -1.0
    *_, pos, fits = _run_both(arch, x)
    cap = tmoe.moe_capacity(40, rcfg)
    assert int((~fits).sum()) == 2 * rcfg.moe.top_k * (40 - cap)
    assert bool(fits[:, :cap].all()) and not bool(fits[:, cap:].any())


def test_tied_experts_take_the_lower_index_first():
    """Two router rows equal: their probabilities tie exactly in every
    token, and ``jax.lax.top_k``'s order (the lower index first) sets the
    choice order and with it the positions; capacity binds."""
    arch = "deepseek-moe-16b"
    rcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    p, _ = _moe_params(arch)
    p = _module(to_reference_tree(p), "cpu")
    with torch.no_grad():
        w = p["router"]["w"]
        w[5] = w[2]
        w[6] = w[2]
    rp = jax.tree.map(jnp.asarray, to_reference_tree(p))
    x = np.random.default_rng(4).standard_normal(
        (2, 24, rcfg.d_model)).astype(np.float32)
    *_, top_e, pos, fits = _run_both(arch, x, p, rp, capacity_factor=0.5)
    want_e, want_pos = _ref_positions(rp, x, rcfg)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    tied = (top_e == 2).any(-1) & (top_e == 5).any(-1)
    assert bool(tied.any()) and int((~fits).sum()) > 0


BANK = (3, 5, 16, 24)         # experts, slots, in, out


def _bank_specs(mode):
    from repro.api.plan import resolve_linear_spec as rres
    from repro.config import WasiConfig as RW

    from repro_torch.api.plan import resolve_linear_spec as tres
    from repro_torch.config import WasiConfig as TW

    kw = {"factored": dict(method="wsi", rank_align=8),
          "dense": dict(method="none"),
          "int8": dict(method="wsi", rank_align=8),
          "project": dict(method="wsi", update_mode="project",
                          rank_align=8)}[mode]
    e, c, i, o = BANK
    rs, ts = (rres(RW(**kw), "moe/w_up", "moe", i, o),
              tres(TW(**kw), "moe/w_up", "moe", i, o))
    if mode == "int8":
        rs = dataclasses.replace(rs, quant="int8")
        ts = dataclasses.replace(ts, quant="int8")
    return rs, ts


@pytest.mark.parametrize("mode", ["factored", "dense", "int8", "project"])
def test_bank_matmul_branches_match_reference(mode):
    from repro.quant.quantize import quantize_linear as rquant

    from repro_torch.quant.quantize import quantize_linear as tquant

    rs, ts = _bank_specs(mode)
    e, c, i, o = BANK
    rng = np.random.default_rng(6)
    k = ts.rank
    bank = {"L": rng.standard_normal((e, o, k)), "R":
            rng.standard_normal((e, k, i))}
    if mode in ("dense", "project"):
        bank = {"w": rng.standard_normal((e, o, i))} | (
            bank if mode == "project" else {})
    bank = {key: v.astype(np.float32) for key, v in bank.items()}
    x = rng.standard_normal((e, c, i)).astype(np.float32)
    rb = {key: jnp.asarray(v) for key, v in bank.items()}
    tb = {key: torch.from_numpy(v) for key, v in bank.items()}
    if mode == "int8":
        rb, tb = rquant(rb, rs), tquant(tb, ts)
        assert set(tb) == {"L", "sL", "R", "sR"}
        for key in tb:
            assert np.asarray(rb[key]).tobytes() == tb[key].numpy().tobytes()
    want = np.asarray(rmoe._bank_matmul(rs, rb, jnp.asarray(x)))
    if mode != "project":
        got = tmoe._bank_matmul(ts, tb, torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)
        return
    tb = {key: v.requires_grad_(True) for key, v in tb.items()}
    got = tmoe._bank_matmul(ts, tb, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)
    got.sum().backward()
    rg = jax.grad(lambda p_: rmoe._bank_matmul(rs, p_, jnp.asarray(x))
                  .sum())(rb)
    np.testing.assert_allclose(_np(tb["w"].grad), np.asarray(rg["w"]),
                               rtol=1e-5, atol=1e-4)
    assert float(tb["w"].grad.abs().max()) > 0
    for key in ("L", "R"):
        assert tb[key].grad is None or not tb[key].grad.any()
        assert not np.asarray(rg[key]).any()


def test_refresh_of_a_two_dim_bank_stack():
    """The factored refresh on (repeat, E, O, K) banks equals the reference's
    on the same stack (``wsi_refresh_factored``: one CholeskyQR per
    matrix, its mix folded into R)."""
    from repro.core.wsi import WSIState as RW
    from repro.core.wsi import wsi_refresh_factored as rref

    from repro_torch.core.wsi import WSIState as TW
    from repro_torch.core.wsi import wsi_refresh_factored as tref

    rng = np.random.default_rng(8)
    L = rng.standard_normal((2, 3, 24, 8)).astype(np.float32)
    R = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    want = rref(RW(L=jnp.asarray(L), R=jnp.asarray(R)))
    got = tref(TW(L=torch.from_numpy(L), R=torch.from_numpy(R)))
    np.testing.assert_allclose(_np(got.L), np.asarray(want.L), atol=1e-5)
    np.testing.assert_allclose(_np(got.R), np.asarray(want.R), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _cfg(pkg, arch, method="wasi", project=False, **moe):
    c = pkg.get_smoke(arch)
    w = dict(method=method, refresh_every=2)
    if project:
        w.update(update_mode="project")
    c = c.replace(wasi=dataclasses.replace(c.wasi, **w))
    return _with_moe(c, **moe) if moe else c


def _install(arch, method="wasi", project=False, **moe):
    rcfg = _cfg(rconfigs, arch, method, project, **moe)
    tcfg = _cfg(tconfigs, arch, method, project, **moe)
    rapi.uninstall(rcfg)
    tapi.uninstall(tcfg)
    rapi.install(rapi.resolve(rcfg, batch=B, seq=S))
    tapi.install(tapi.resolve(tcfg, batch=B, seq=S))
    return rcfg, tcfg


@functools.cache
def _weights(arch, project=False, dtype="float32"):
    """The port's weights (seed 5) as the reference's numpy tree; the
    factored layout, or project mode's dense one."""
    _, tcfg = _install(arch, "wsi", project)
    model = tlm.init_lm(tcfg.replace(dtype=dtype), device="cpu", seed=5)
    return to_reference(model)


def _batches(vocab=256):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (B, S + 1))
        out.append({"tokens": t[:, :-1].astype(np.int32),
                    "labels": t[:, 1:].astype(np.int32)})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_aux_and_gradients_match_reference(arch):
    """capacity_factor 0.5, so choices drop in every layer."""
    rcfg, tcfg = _install(arch, "wsi", capacity_factor=0.5)
    tree = _weights(arch)
    rparams = jax.tree.map(jnp.asarray, tree)
    model = from_reference(tree, tcfg, "cpu", trainable=True)
    b = _batches()[0]
    lr, _, _, ar = rlm.lm_forward(rparams, jnp.asarray(b["tokens"]), rcfg)
    lt, _, _, at = tlm.lm_forward(model, torch.from_numpy(b["tokens"]).long(),
                                  tcfg)
    np.testing.assert_allclose(_np(lt), np.asarray(lr), **TOL)
    np.testing.assert_allclose(float(at.detach()), float(ar), rtol=1e-6)
    assert float(at.detach()) > 0
    (rloss, (_, rmet)), rgrad = jax.jit(jax.value_and_grad(
        lambda p: rlm.lm_loss(p, jax.tree.map(jnp.asarray, b), rcfg),
        has_aux=True))(rparams)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    loss, (_, met) = tlm.lm_loss(model, tb, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    np.testing.assert_allclose(float(met["aux"]), float(rmet["aux"]),
                               rtol=1e-6)
    got = _nest(tree, {n: p.grad.numpy() for n, p in
                       model.named_parameters()})
    flat_got, tdef = jax.tree_util.tree_flatten_with_path(got)
    flat_want, wdef = jax.tree.flatten(rgrad)
    assert jax.tree.structure(got) == wdef
    for (path, g), w in zip(flat_got, flat_want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))
    router = [g for path, g in flat_got
              if "'router'" in jax.tree_util.keystr(path)]
    assert router and all(np.abs(g).max() > 0 for g in router)


GATE = dict(optimizer="sgd", lr=0.3, momentum=0.9)
# the momenta sum 4 steps of gradients whose f32 sums run in other orders;
# the largest gaps measured on these inputs, of each leaf's scale: 1.2e-5
# (mixtral wsi), 1.1e-5 (mixtral wasi), 2.1e-5 (deepseek wsi), 3.6e-6
# (project mode); 2.4x the largest
MU_TOL = 5e-5
GATES = [("mixtral-8x7b", "wsi", False), ("mixtral-8x7b", "wasi", False),
         ("deepseek-moe-16b", "wsi", False), ("deepseek-moe-16b", "wsi", True)]


def _tree_close(got, want, rel):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    assert tg == tw
    for (path, g), w in zip(fg, fw):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch,method,project", GATES)
def test_train_steps_match_reference(arch, method, project):
    """4 steps of ``make_train_step`` (SGD + momentum, clip 2.0; refresh
    every 2 in factored mode, so two refreshes walk the (repeat, E)
    banks; project mode keeps a WSI state per bank and steps it). Losses,
    ``ce`` and ``aux`` within 1e-5 relative, grad_norm within 1e-4;
    params within 1e-5 of each leaf's scale (the largest gap measured on
    these inputs, 3.1e-6); momenta within ``MU_TOL`` of it; project
    mode's factors within 1e-4."""
    rcfg, tcfg = _install(arch, method, project)
    kw = dict(GATE, steps=STEPS, clip_norm=2.0, checkpoint_every=0)
    rparams = jax.tree.map(jnp.asarray, _weights(arch, project))
    st = (rlm.init_lm_states(KEY, rcfg, B, S) if rcfg.wasi.compress_acts
          else None)
    rstate = rmake_state(KEY, rparams, rcfg, RTrainConfig(**kw),
                         asi_states=st)
    if project:
        assert any("/experts/" in k for k in rstate.wsi)
        assert not any("router" in k for k in rstate.wsi)
    state = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                 "cpu")
    rstep = jax.jit(rmake_step(rlm.lm_loss, rcfg, RTrainConfig(**kw)))
    step = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))
    for i, b in enumerate(_batches()):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        for k in ("loss", "grad_norm", "ce", "aux"):
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol,
                                       err_msg=f"step {i} {k}")
    out = state_to_reference(state)
    _tree_close(out["params"], rstate.params, 1e-5)
    _tree_close(out["mu"], rstate.opt.mu, MU_TOL)
    if project:
        _tree_close({k: (v.L, v.R) for k, v in out["wsi"].items()},
                    {k: (v.L, v.R) for k, v in rstate.wsi.items()}, 1e-4)


def test_int8_packs_and_bytes_match_reference():
    """``plan.quantized("int8")`` -> ``convert.quantize``: every bank packs
    to {L, sL, R, sR} with per-expert per-channel scales, byte for byte
    the reference's; the router stays f32 and unpacked; the weight byte
    counts agree."""
    arch = "mixtral-8x7b"
    rcfg, tcfg = _install(arch)
    tree = _weights(arch)
    rq = rconvert.quantize(jax.tree.map(jnp.asarray, tree),
                           rapi.plan_of(rcfg).quantized("int8"))
    tq = tconvert.quantize(tree_to_torch(tree),
                           tapi.plan_of(tcfg).quantized("int8"))
    moe = tq["groups"][0][0]["moe"]
    assert set(moe["experts"]["w_up"]) == {"L", "sL", "R", "sR"}
    assert moe["experts"]["w_up"]["sL"].shape == (2, 4, 128)
    assert set(moe["router"]) == {"w"}
    assert moe["router"]["w"].dtype == torch.float32
    fr, tr = jax.tree.flatten(jax.tree.map(np.asarray, rq))
    ft, tt = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), tq))
    assert tr == tt
    for a, b in zip(fr, ft):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    from repro.utils.memprof import model_weight_bytes as rbytes
    want = rbytes(rq)
    got = model_weight_bytes(tq)
    for k in ("weights_bytes", "scales_bytes", "total_bytes", "n_linears"):
        assert got[k] == want[k], k
    tapi.install(tapi.plan_of(tcfg).quantized("int8"))
    model = from_reference(tq, tcfg, "cpu")
    tapi.uninstall(tcfg)
    assert bind.is_quantized(model.groups[0][0]["moe"]["experts"]["w_up"])


def tree_to_torch(node):
    if isinstance(node, dict):
        return {k: tree_to_torch(v) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to_torch(v) for v in node]
    return torch.from_numpy(np.array(node))


def _flat_np(node):
    return [np.asarray(a) for a in jax.tree.leaves(node)]


def test_train_state_checkpoint_crosses_both_ways(tmp_path):
    """deepseek smoke in bf16 (the router f32 beside bf16 banks), a
    plan-bearing ``train_state`` written by either package and restored
    by the other, leaves bit for bit and dtypes kept."""
    arch = "deepseek-moe-16b"
    rcfg, tcfg = _install(arch, "wsi")
    rcfg, tcfg = rcfg.replace(dtype="bfloat16"), tcfg.replace(
        dtype="bfloat16")
    rplan, tplan = rapi.resolve(rcfg), tapi.resolve(tcfg)
    kw = dict(GATE, steps=1, checkpoint_every=0)
    tree = _weights(arch, dtype="bfloat16")
    # to_reference gives bf16 leaves as f32 arrays of the same values
    rparams = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if "'router'" in
                                    jax.tree_util.keystr(path)
                                    else jnp.bfloat16), tree)
    rstate = rmake_state(KEY, rparams, rcfg, RTrainConfig(**kw))
    assert rstate.params["groups"][1][0]["moe"]["router"]["w"].dtype == \
        jnp.float32
    rsave(str(tmp_path / "ref"), 1, rstate, plan=rplan, label="train_state")
    template = state_from_reference(jax.tree.map(np.asarray, rstate), tcfg,
                                    "cpu")
    with torch.no_grad():
        for p in template.params.parameters():
            p.zero_()
    got = restore_checkpoint(str(tmp_path / "ref"), 1, template)
    router = got.params.groups[1][0]["moe"]["router"]["w"]
    assert router.dtype == torch.float32
    assert got.params.groups[1][0]["moe"]["experts"]["w_up"]["L"].dtype == \
        torch.bfloat16
    for a, b in zip(_flat_np(state_to_reference(got)["params"]),
                    _flat_np(rstate.params)):
        assert np.array_equal(a, np.asarray(b, np.float32))
    # port -> reference, after a step of the port's own
    model = tlm.init_lm(tcfg, device="cpu", seed=5)      # tree's values
    state = make_train_state(model, tcfg, TrainConfig(**kw))
    b = _batches()[0]
    state, _ = make_train_step(tlm.lm_loss, tcfg, TrainConfig(**kw))(
        state, {k: torch.from_numpy(v).long() for k, v in b.items()})
    assert state.params.groups[1][0]["moe"]["router"]["w"].dtype == \
        torch.float32
    save_checkpoint(str(tmp_path / "port"), 1, state, plan=tplan,
                    label="train_state")
    back = rrestore(str(tmp_path / "port"), 1, rstate)
    assert back.params["groups"][1][0]["moe"]["router"]["w"].dtype == \
        jnp.float32
    for a, b in zip(_flat_np(back.params),
                    _flat_np(state_to_reference(state)["params"])):
        if a.dtype.kind == "V":     # np.load's view of a bf16 leaf
            a = a.view(jnp.bfloat16)
        assert np.array_equal(a.astype(np.float32), b)
    assert tconvert.load_plan(str(tmp_path / "port")).model == tcfg


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_slots=2, max_cache=32, buckets=(8, 16))
PAGED_KW = dict(paged=True, page_size=8, prefill_chunk=8)
PROMPT_LENS = (3, 13, 6, 16)


@pytest.mark.parametrize("arch,paged", [("mixtral-8x7b", False),
                                        ("deepseek-moe-16b", False),
                                        ("deepseek-moe-16b", True)])
def test_engine_greedy_tokens_match_reference_engine(arch, paged):
    """Prompts through two slots (queueing, slot recycling, two
    buckets; paged: chunks of 8, each its own capacity group), greedy:
    the port's engine gives the reference's engine's tokens in the same
    mode, and launches nothing on the CPU."""
    rcfg, tcfg = _install(arch, "wsi")
    tree = _weights(arch)
    model = from_reference(tree, tcfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(0, rcfg.vocab_size, n)))
               for n in PROMPT_LENS]
    kw = dict(ENGINE_KW, **(PAGED_KW if paged else {}))
    reng = rserve.ServeEngine(jax.tree.map(jnp.asarray, tree), rcfg, **kw)
    rh = [reng.submit(p, max_new=4) for p in prompts]
    reng.run()
    ops.reset_launches()
    teng = ServeEngine(model, tcfg, device="cpu", **kw)
    th = [teng.submit(p, max_new=4) for p in prompts]
    teng.run()
    assert [h.generated for h in th] == [h.generated for h in rh]
    assert teng.paged == paged
    assert not any(ops.launch_counts().values())


def test_paged_refused_for_the_windowed_mixtral():
    _, tcfg = _install("mixtral-8x7b", "wsi")
    assert not tlm.supports_paging(tcfg)
    assert tlm.supports_paging(_install("deepseek-moe-16b", "wsi")[1])
    model = tlm.init_lm(tcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, tcfg, device="cpu", **ENGINE_KW, **PAGED_KW)
    with pytest.raises(ValueError, match="paged KV"):
        tlm.init_lm_cache(tcfg, 1, 8, device="cpu", pages=4, page_size=8)


@pytest.mark.parametrize("argv", [
    ["--arch", "mixtral-8x7b"],
    ["--arch", "deepseek-moe-16b", "--paged", "--page-size", "8",
     "--prefill-chunk", "8"],
    ["--arch", "mixtral-8x7b", "--quant", "int8"]])
def test_serve_launcher(argv, capsys):
    from repro_torch.launch import serve as launch

    launch.main(["--device", "cpu", "--batch", "3", "--max-slots", "2",
                 "--tokens", "4"] + argv)
    out = capsys.readouterr().out
    assert "[serve]" in out
    if "--paged" in argv:
        assert "paged" in out


def test_train_launcher_logs_aux(capsys):
    from repro_torch.launch import train as launch

    launch.main(["--device", "cpu", "--arch", "deepseek-moe-16b", "--steps",
                 "2", "--wasi", "wsi"])
    out = capsys.readouterr().out
    assert "aux" in out
