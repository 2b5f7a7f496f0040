"""The port's int8 deployment against the reference's, on the same numpy
inputs: quantization packs, the q8 factored product, the quantized plan,
model-tree conversion, bind dispatch, and the slice gate, an int8
checkpoint written by either package served by both with the same greedy
tokens.

Tolerances: int8 packs are held identical and scales within 1 f32 ulp
(both packages divide, round half to even and clip in f32). The q8 product
is held at the reference test's own tolerances (2e-5 I absolute in f32,
0.1 in bf16, rtol 1e-2); a model forward through int8 factors differs from
the reference's only by the order of f32 sums, so greedy tokens must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.serve as rserve
import repro_torch.configs as tconfigs
from repro import api as rapi
from repro.api import bind as rbind
from repro.api import convert as rconvert
from repro.api.plan import SubspacePlan as RPlan
from repro.api.plan import resolve_linear_spec as rresolve_spec
from repro.checkpoint import save_checkpoint as rsave
from repro.config import TrainConfig as RTrainConfig
from repro.config import WasiConfig as RWasi
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.kernels import ops as rops
from repro.quant import quantize as rquant
from repro.train.step import make_train_state as rmake_state
from repro.train.step import make_train_step as rmake_step
from repro.utils.memprof import model_weight_bytes as rweight_bytes
from repro_torch import api as tapi
from repro_torch.api import bind as tbind
from repro_torch.api import convert as tconvert
from repro_torch.api.bridge import from_reference
from repro_torch.api.plan import SubspacePlan as TPlan
from repro_torch.api.plan import resolve_linear_spec as tresolve_spec
from repro_torch.checkpoint import save_checkpoint as tsave
from repro_torch.config import TrainConfig
from repro_torch.config import WasiConfig as TWasi
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tkquant
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tlaunch
from repro_torch.quant import quantize as tquant
from repro_torch.serve import ServeEngine
from repro_torch.train.step import make_train_state
from repro_torch.utils.memprof import model_weight_bytes as tweight_bytes

torch.set_num_threads(1)
SMOKE = "qwen2-0.5b"


def _t(a) -> torch.Tensor:
    """numpy (or a JAX array, bf16 included) -> torch, bits kept."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _ttree(tree):
    """A nested dict/list of numpy arrays as torch tensors (copies)."""
    return jax.tree.map(_t, tree)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _spec_json(spec_json: dict) -> dict:
    """A spec's JSON without ``bwd_fits_vmem``, the reference's TPU VMEM
    fit rule, which the port leaves None by design (api/plan.py)."""
    return {k: v for k, v in spec_json.items() if k != "bwd_fits_vmem"}


def _plan_json(plan_json: dict) -> dict:
    return dict(plan_json, specs=[_spec_json(s) for s in plan_json["specs"]])


def _assert_packs_equal(got_q, got_s, want_q, want_s):
    want_q, want_s = np.asarray(want_q), np.asarray(want_s)
    assert got_q.dtype == torch.int8 and want_q.dtype == np.int8
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert got_s.dtype == torch.float32
    np.testing.assert_array_max_ulp(got_s.numpy(), want_s, maxulp=1)


# ---------------------------------------------------------------------------
# tensors and linear dicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(24, 16), (3, 24, 16), (2, 2, 8, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_packs_identical(shape, dtype):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    wj = jnp.asarray(w).astype(dtype)
    want_q, want_s = rquant.quantize_tensor(wj)
    got_q, got_s = tquant.quantize_tensor(_t(wj))
    _assert_packs_equal(got_q, got_s, want_q, want_s)
    np.testing.assert_array_max_ulp(
        tquant.dequantize_tensor(got_q, got_s).numpy(),
        np.asarray(rquant.dequantize_tensor(want_q, want_s)), maxulp=1)


def test_quantize_tensor_zero_channel():
    w = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    w[2] = 0.0
    got_q, got_s = tquant.quantize_tensor(torch.from_numpy(w))
    want_q, want_s = rquant.quantize_tensor(jnp.asarray(w))
    _assert_packs_equal(got_q, got_s, want_q, want_s)
    assert float(got_s[2]) == 1.0 and not got_q[2].any()
    assert not tquant.dequantize_tensor(got_q, got_s)[2].any()


@pytest.mark.parametrize("layout", ["factored", "dense"])
def test_quantize_linear_layouts_and_double_quant_raises(layout):
    wasi = dict(method="wsi" if layout == "factored" else "none",
                rank_align=8)
    rspec = dataclasses.replace(
        rresolve_spec(RWasi(**wasi), "mlp/up", "mlp", 16, 24), quant="int8")
    tspec = dataclasses.replace(
        tresolve_spec(TWasi(**wasi), "mlp/up", "mlp", 16, 24), quant="int8")
    assert _spec_json(rspec.to_json()) == _spec_json(tspec.to_json())
    rng = np.random.default_rng(3)
    if layout == "factored":
        p = {"L": rng.standard_normal((24, rspec.rank)),
             "R": rng.standard_normal((rspec.rank, 16))}
    else:
        p = {"w": rng.standard_normal((24, 16))}
    p["b"] = rng.standard_normal(24)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = rquant.quantize_linear({k: jnp.asarray(v) for k, v in p.items()},
                                  rspec)
    got = tquant.quantize_linear({k: torch.from_numpy(v)
                                  for k, v in p.items()}, tspec)
    assert sorted(got) == sorted(want)
    for key, scale in tquant.SCALE_KEY.items():
        if key in got:
            _assert_packs_equal(got[key], got[scale], want[key], want[scale])
    np.testing.assert_array_equal(got["b"].numpy(), p["b"])
    with pytest.raises(ValueError, match="already quantized"):
        tquant.quantize_linear(got, tspec)
    back, rback = tquant.dequantize_linear(got), rquant.dequantize_linear(want)
    assert sorted(back) == sorted(rback)
    for key in back:
        np.testing.assert_array_max_ulp(back[key].numpy(),
                                        np.asarray(rback[key]), maxulp=1)
    # an unstamped spec passes through
    plain = {k: torch.from_numpy(v) for k, v in p.items()}
    assert tquant.quantize_linear(
        plain, dataclasses.replace(tspec, quant=None)) is plain


# ---------------------------------------------------------------------------
# the q8 factored product (kernel #6's plain version and dispatch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,i,k,o", [(4, 16, 4, 24), (7, 33, 5, 17),
                                     (130, 257, 40, 129), (128, 128, 32, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_q8_matmul_matches_reference(m, i, k, o, dtype):
    """The reference test's inputs and tolerances: its Pallas kernel in
    interpret mode and its dispatching entry against the port's plain
    version and its CPU dispatch, leading batch dims included."""
    x = jax.random.normal(jax.random.PRNGKey(2), (m, i)).astype(dtype)
    lq, ls = rquant.quantize_tensor(
        jax.random.normal(jax.random.PRNGKey(3), (o, k)))
    rq, rs = rquant.quantize_tensor(
        jax.random.normal(jax.random.PRNGKey(4), (k, i)))
    tol = 2e-5 * i if dtype == jnp.float32 else 0.1
    want = np.asarray(rops.lowrank_matmul_q8_fused(x, rq, rs, lq, ls),
                      np.float32)
    want2 = np.asarray(rops.lowrank_matmul_q8(x.reshape(1, m, i), rq, rs,
                                              lq, ls), np.float32)
    tx, trq, trs, tlq, tls = (_t(a) for a in (x, rq, rs, lq, ls))
    got = tref.lowrank_q8_ref(tx, trq, trs, tlq, tls)
    got2 = tops.lowrank_matmul_q8(tx.reshape(1, m, i), trq, trs, tlq, tls)
    assert got.dtype == tx.dtype and got2.shape == (1, m, o)
    for g in (_np(got), _np(got2).reshape(m, o)):
        np.testing.assert_allclose(g, want, atol=tol, rtol=1e-2)
        np.testing.assert_allclose(g, want2.reshape(m, o), atol=tol,
                                   rtol=1e-2)


def test_dense_q8_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wq, ws = rquant.quantize_tensor(jnp.asarray(
        rng.standard_normal((24, 16)).astype(np.float32)))
    want = np.asarray(rops.dense_matmul_q8(jnp.asarray(x), wq, ws))
    got = tops.dense_matmul_q8(torch.from_numpy(x), _t(wq), _t(ws))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_path_counts_no_q8_launch_and_the_kernel_refuses_cpu():
    x = torch.randn(4, 16)
    rq, rs = tquant.quantize_tensor(torch.randn(8, 16))
    lq, ls = tquant.quantize_tensor(torch.randn(24, 8))
    tops.reset_launches()
    tops.lowrank_matmul_q8(x, rq, rs, lq, ls)
    assert tops.launch_counts()["lowrank_q8"] == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tkquant.lowrank_q8(x, rq, rs, lq, ls)
    assert tops.launch_counts()["lowrank_q8"] == 0


# ---------------------------------------------------------------------------
# plans, bind, conversion
# ---------------------------------------------------------------------------

def test_plan_quantized_json_equals_reference():
    rplan = rapi.resolve(rconfigs.get_smoke(SMOKE))
    tplan = tapi.resolve(tconfigs.get_smoke(SMOKE))
    rq, tq = rplan.quantized("int8"), tplan.quantized("int8")
    assert tq.is_quantized and not tplan.is_quantized and tq != tplan
    assert _plan_json(tq.to_json()) == _plan_json(rq.to_json())
    assert TPlan.loads(tq.dumps()) == tq
    # a plan read from the reference's JSON stamps to the reference's
    # stamped JSON exactly, fit rule included, and reads back in it
    from_ref = TPlan.from_json(rplan.to_json()).quantized("int8")
    assert from_ref.to_json() == rq.to_json()
    assert RPlan.from_json(from_ref.to_json()) == rq
    assert TPlan.from_json(rq.to_json()) == from_ref
    for s in tq.specs:
        assert s.quant == ("int8" if s.mode in ("factored", "dense") else None)


def test_bind_apply_q8_dispatch_and_refusals():
    rw, tw = RWasi(method="wsi", rank_align=8), TWasi(method="wsi",
                                                      rank_align=8)
    rspec = rresolve_spec(rw, "mlp/up", "mlp", 16, 24)
    tspec = tresolve_spec(tw, "mlp/up", "mlp", 16, 24)
    rq_spec = dataclasses.replace(rspec, quant="int8")
    tq_spec = dataclasses.replace(tspec, quant="int8")
    rng = np.random.default_rng(6)
    p = {"L": rng.standard_normal((24, rspec.rank)).astype(np.float32),
         "R": rng.standard_normal((rspec.rank, 16)).astype(np.float32)}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    rqp = rquant.quantize_linear({k: jnp.asarray(v) for k, v in p.items()},
                                 rq_spec)
    tqp = tquant.quantize_linear({k: torch.from_numpy(v)
                                  for k, v in p.items()}, tq_spec)
    want, _ = rbind.apply(rq_spec, rqp, jnp.asarray(x), rw)
    got, ns = tbind.apply(tq_spec, tqp, torch.from_numpy(x), tw)
    assert ns is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="serve-only"):
        tbind.apply(tq_spec, tqp, torch.from_numpy(x), tw, state=object())
    with pytest.raises(ValueError, match="not packed"):
        tbind.apply(tq_spec, tp, torch.from_numpy(x), tw)
    with pytest.raises(ValueError, match="spec is not"):
        tbind.apply(tspec, tqp, torch.from_numpy(x), tw)


@pytest.fixture(scope="module")
def smoke_tree():
    """The reference's qwen2 smoke init (f32, factored), as numpy."""
    rcfg = rconfigs.get_smoke(SMOKE)
    rparams = rlm.init_lm(jax.random.PRNGKey(0), rcfg, jnp.float32)
    return jax.tree.map(np.asarray, rparams)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def test_convert_quantize_dequantize_densify_factorize(smoke_tree):
    rplan = rapi.resolve(rconfigs.get_smoke(SMOKE))
    tplan = tapi.resolve(tconfigs.get_smoke(SMOKE))
    rqplan, tqplan = rplan.quantized("int8"), tplan.quantized("int8")
    ttree = _ttree(smoke_tree)
    rq = _leaves(rconvert.quantize(smoke_tree, rqplan))
    tq = _leaves(tconvert.quantize(ttree, tqplan))
    assert sorted(rq) == sorted(tq)
    for path, want in rq.items():
        got = tq[path]
        if path.endswith(("/sL", "/sR", "/sW")):
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), 1)
        else:
            assert str(got.dtype)[6:] == str(np.asarray(want).dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the untreated tied embedding passes through; the bytes shrink
    assert tq["/embed/w"].dtype == torch.float32
    b32, b8 = tweight_bytes(ttree), tweight_bytes(tconvert.quantize(
        ttree, tqplan))
    assert b8 == {k: v for k, v in rweight_bytes(rconvert.quantize(
        smoke_tree, rqplan)).items() if k in b8}
    assert b8["weights_bytes"] < b32["weights_bytes"]
    assert b8["scales_bytes"] > 0 == b32["scales_bytes"]
    # dequantize / densify agree with the reference's (products, f32)
    for fn, plan_t, plan_r in (("dequantize", tqplan, rqplan),
                               ("densify", tqplan, rqplan)):
        packed_t = tconvert.quantize(ttree, tqplan)
        packed_r = rconvert.quantize(smoke_tree, rqplan)
        got = _leaves(getattr(tconvert, fn)(packed_t, plan_t))
        want = _leaves(getattr(rconvert, fn)(packed_r, plan_r))
        assert sorted(got) == sorted(want)
        for path in want:
            w = np.asarray(want[path])
            np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                       atol=1e-6 * max(np.abs(w).max(), 1))
    with pytest.raises(ValueError, match="already factored or quantized"):
        tconvert.factorize(tconvert.quantize(ttree, tqplan), tqplan)
    # factorize(densify(.)) recovers L @ R in both packages (the dense W
    # has rank K exactly, so the truncated SVD is well determined; L and R
    # themselves depend on LAPACK's sign choices)
    dense_t = tconvert.densify(ttree, tplan)
    dense_r = rconvert.densify(smoke_tree, rplan)
    ft = tconvert.factorize(dense_t, tplan)
    fr = rconvert.factorize(dense_r, rplan)
    for (pt, lt), (pr, lr) in zip(tbind.iter_linear_dicts(ft["groups"]),
                                  rbind.iter_linear_dicts(fr["groups"])):
        assert pt == pr and sorted(lt) == sorted(lr)
        w = np.einsum("...ok,...ki->...oi", np.asarray(lr["L"]),
                      np.asarray(lr["R"]))
        g = torch.matmul(lt["L"], lt["R"]).numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    # the error report: the same records
    rrec = rquant.error_report(smoke_tree, rqplan)
    trec = tquant.error_report(ttree, tqplan)
    assert [(r["site"], r["tensor"], r["f32_bytes"], r["q8_bytes"])
            for r in trec] == [(r["site"], r["tensor"], r["f32_bytes"],
                                r["q8_bytes"]) for r in rrec]
    for a, b in zip(trec, rrec):
        assert abs(a["rel_err"] - b["rel_err"]) <= 1e-6 * b["rel_err"] + 1e-9
    assert "**total**" in tquant.format_error_report(trec)


def test_int8_trees_refuse_to_train(smoke_tree):
    tcfg = tconfigs.get_smoke(SMOKE)
    tapi.uninstall(tcfg)
    qplan = tapi.resolve(tcfg).quantized("int8")
    qtree = tconvert.quantize(_ttree(smoke_tree),
                              qplan)
    try:
        tapi.install(qplan)
        with pytest.raises(ValueError, match="cannot require grad"):
            from_reference(qtree, tcfg, "cpu", trainable=True)
        model = from_reference(qtree, tcfg, "cpu")
        with pytest.raises(ValueError, match="int8"):
            make_train_state(model, tcfg.replace(wasi=dataclasses.replace(
                tcfg.wasi, method="wsi")), TrainConfig())
        # an int8 tree under the f32 plan is refused as well
        tapi.uninstall(tcfg)
        with pytest.raises(ValueError, match="int8-packed"):
            from_reference(qtree, tcfg, "cpu")
    finally:
        tapi.uninstall(tcfg)


# ---------------------------------------------------------------------------
# the slice gate: int8 checkpoints served by both packages
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6]]


@pytest.fixture(scope="module")
def trained():
    """qwen2 smoke trained briefly by the reference, as
    tests/test_quant.py's acceptance test does (random init has top-2
    logit gaps below the quantization noise): (params as numpy, the
    reference's plan)."""
    cfg = rconfigs.get_smoke(SMOKE)
    rapi.uninstall(cfg)
    b, s = 8, 16
    plan = rapi.resolve(cfg, batch=b, seq=s)
    rapi.install(plan)
    try:
        key = jax.random.PRNGKey(0)
        tcfg = RTrainConfig(optimizer="sgd", lr=0.3, momentum=0.9,
                            checkpoint_every=0)
        state = rmake_state(key, rlm.init_lm(key, cfg), cfg, tcfg,
                            asi_states=rlm.init_lm_states(key, cfg, b, s))
        step = jax.jit(rmake_step(rlm.lm_loss, cfg, tcfg))
        data = RSyntheticLM(vocab_size=cfg.vocab_size, seq_len=s,
                            global_batch=b, seed=1)
        for i in range(30):
            state, _ = step(state, data.batch(i))
        return jax.tree.map(np.asarray, state.params), plan
    finally:
        rapi.uninstall(cfg)


def _drive(engine):
    reqs = [engine.submit(p, max_new=8) for p in PROMPTS]
    engine.run()
    return [r.tokens for r in reqs]


def _reference_tokens(ckpt_dir):
    cfg = rconfigs.get_smoke(SMOKE)
    rapi.uninstall(cfg)
    try:
        eng = rserve.ServeEngine.from_checkpoint(ckpt_dir, max_slots=2,
                                                 max_cache=16)
        return _drive(eng), eng.summary(), eng.plan
    finally:
        rapi.uninstall(cfg)


def _port_tokens(ckpt_dir):
    cfg = tconfigs.get_smoke(SMOKE)
    tapi.uninstall(cfg)
    try:
        tops.reset_launches()
        eng = ServeEngine.from_checkpoint(ckpt_dir, device="cpu",
                                          max_slots=2, max_cache=16)
        toks = _drive(eng)
        assert set(tops.launch_counts().values()) == {0}   # plain on CPU
        return toks, eng.summary(), eng.plan
    finally:
        tapi.uninstall(cfg)


def test_slice_gate_reference_int8_checkpoint_serves_in_port(trained,
                                                            tmp_path):
    """The reference trains, quantizes and saves with its stamped plan;
    both packages' ``ServeEngine.from_checkpoint`` serve it: the same
    greedy tokens, an equal plan, equal packed weight bytes, below the f32
    engine's."""
    params, plan = trained
    qplan = plan.quantized("int8")
    rsave(str(tmp_path), 30, rconvert.quantize(params, qplan), plan=qplan,
          label="params")
    rtoks, rsum, rplan = _reference_tokens(str(tmp_path))
    ttoks, tsum, tplan = _port_tokens(str(tmp_path))
    assert ttoks == rtoks
    assert tsum["quantized"] and rsum["quantized"]
    assert tplan.to_json() == rplan.to_json() == qplan.to_json()
    assert tsum["weight_bytes"] == rsum["weight_bytes"]
    tcfg = tconfigs.get_smoke(SMOKE)
    tapi.uninstall(tcfg)
    try:
        f32 = ServeEngine(from_reference(params, tcfg, "cpu"), tcfg,
                          device="cpu", max_slots=2, max_cache=16)
        assert tsum["weight_bytes"] < f32.summary()["weight_bytes"]
    finally:
        tapi.uninstall(tcfg)


def test_slice_gate_port_int8_checkpoint_serves_in_reference(trained,
                                                            tmp_path):
    """The reverse: the port quantizes the trained params and saves them
    with its stamped plan; the reference serves the same tokens."""
    params, plan = trained
    tplan = TPlan.from_json(plan.to_json()).quantized("int8")
    qtree = tconvert.quantize(_ttree(params), tplan)
    tsave(str(tmp_path), 30, qtree, plan=tplan, label="params")
    rtoks, rsum, rplan = _reference_tokens(str(tmp_path))
    ttoks, tsum, _ = _port_tokens(str(tmp_path))
    assert rtoks == ttoks and rsum["quantized"]
    assert rplan.to_json() == tplan.to_json()
    assert tsum["weight_bytes"] == rsum["weight_bytes"]


def test_serve_launcher_quant_and_ckpt(trained, tmp_path):
    """``launch.serve --quant int8`` on a fresh smoke init, and ``--ckpt``
    with ``--quant`` on an f32 plan-bearing checkpoint (packed on load)."""
    params, plan = trained
    cfg = tconfigs.get_smoke(SMOKE)
    tsave(str(tmp_path), 30, _ttree(params),
          plan=TPlan.from_json(plan.to_json()), label="params")
    try:
        tapi.uninstall(cfg)
        s = tlaunch.main(["--device", "cpu", "--quant", "int8", "--batch",
                          "3", "--max-slots", "2", "--tokens", "4"])
        assert s["quantized"] and s["completed"] == 3
        tapi.uninstall(cfg)
        s8 = tlaunch.main(["--device", "cpu", "--ckpt", str(tmp_path),
                           "--quant", "int8", "--batch", "2",
                           "--tokens", "3"])
        tapi.uninstall(cfg)
        s32 = tlaunch.main(["--device", "cpu", "--ckpt", str(tmp_path),
                            "--batch", "2", "--tokens", "3"])
    finally:
        tapi.uninstall(cfg)
    assert s8["quantized"] and not s32["quantized"]
    assert s8["weight_bytes"] < s32["weight_bytes"]
