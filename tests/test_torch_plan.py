"""The port's SubspacePlan resolves exactly as the reference's."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rconfigs
import repro_torch.api as tapi
import repro_torch.configs as tconfigs
from repro_torch.api.plan import SubspacePlan

FIELDS = ("name", "role", "in_dim", "out_dim", "mode", "rank", "bias",
          "kernel")


def _cfgs(full: bool):
    if full:
        return rconfigs.get("qwen2-0.5b"), tconfigs.get("qwen2-0.5b")
    return rconfigs.get_smoke("qwen2-0.5b"), tconfigs.get_smoke("qwen2-0.5b")


@pytest.mark.parametrize("full", [True, False])
def test_resolved_specs_match_reference(full):
    rcfg, tcfg = _cfgs(full)
    ref = rapi.resolve(rcfg)
    got = tapi.resolve(tcfg)
    assert [tuple(getattr(s, f) for f in FIELDS) for s in got.specs] == \
        [tuple(getattr(s, f) for f in FIELDS) for s in ref.specs]
    # the configs themselves serialize identically
    assert json.dumps(got.to_json()["model"], sort_keys=True) == \
        json.dumps(ref.to_json()["model"], sort_keys=True)


def test_full_width_plan_factors_all_seven_sites():
    plan = tapi.resolve(tconfigs.get("qwen2-0.5b"))
    dims = {s.name: (s.in_dim, s.rank, s.out_dim, s.bias) for s in plan.specs}
    assert dims == {
        "attn/wq": (896, 256, 896, True), "attn/wk": (896, 128, 128, True),
        "attn/wv": (896, 128, 128, True), "attn/wo": (896, 256, 896, False),
        "mlp/gate": (896, 256, 4864, False), "mlp/up": (896, 256, 4864, False),
        "mlp/down": (4864, 256, 896, False)}
    assert all(s.kernel == "fused_lowrank" for s in plan.specs)
    assert all(s.bwd_fits_vmem is None for s in plan.specs)


@pytest.mark.parametrize("full", [True, False])
def test_plan_json_round_trips_and_reads_reference_json(full):
    rcfg, tcfg = _cfgs(full)
    plan = tapi.resolve(tcfg, batch=2, seq=16)
    assert SubspacePlan.loads(plan.dumps()) == plan
    ref = rapi.resolve(rcfg, batch=2, seq=16)
    from_ref = SubspacePlan.loads(ref.dumps())
    assert from_ref.model == tcfg
    for a, b in zip(from_ref.specs, plan.specs):
        assert a.asi_ranks == b.asi_ranks
        assert tuple(getattr(a, f) for f in FIELDS) == \
            tuple(getattr(b, f) for f in FIELDS)


def test_install_plan_of_uninstall():
    cfg = tconfigs.get_smoke("qwen2-0.5b").replace(name="plan-install-test")
    plan = tapi.resolve(cfg, batch=1, seq=4)
    assert tapi.installed(cfg) is None
    assert tapi.plan_of(cfg) == tapi.resolve(cfg)
    tapi.install(plan)
    try:
        assert tapi.plan_of(cfg) is plan
    finally:
        tapi.uninstall(cfg)
    assert tapi.installed(cfg) is None


def test_unported_paths_raise():
    """Calibrated resolution is ported: a {site: weight} mapping gives the
    reference's epsilon rank at that site (and the static ranks
    elsewhere), the plan marked calibrated. mixtral-8x7b still raises."""
    rcfg, cfg = _cfgs(False)
    w = np.random.default_rng(0).standard_normal((128, 64)).astype(
        np.float32)
    got = tapi.resolve(cfg, calibration={"mlp/up": torch.from_numpy(w)})
    want = rapi.resolve(rcfg, calibration={"mlp/up": jnp.asarray(w)})
    assert got.calibrated and want.calibrated
    assert [tuple(getattr(s, f) for f in FIELDS) for s in got.specs] == \
        [tuple(getattr(s, f) for f in FIELDS) for s in want.specs]
    assert got.spec("mlp/up").rank != tapi.resolve(cfg).spec("mlp/up").rank
    with pytest.raises(KeyError, match="ROADMAP"):
        tconfigs.get("mixtral-8x7b")
