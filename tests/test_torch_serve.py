"""The port's serve engine (dense slots) against the reference's, on qwen2
smoke with the same parameters carried across by ``api.bridge``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.lm as rlm
import repro.serve as rserve
import repro_torch.configs as tconfigs
from repro_torch.api.bridge import from_reference
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import SamplingParams, ServeEngine, bucket_for

torch.set_num_threads(1)
ENGINE_KW = dict(max_slots=2, max_cache=64, buckets=(4, 8, 16))
LENGTHS = (3, 7, 5, 11, 20)


@pytest.fixture(scope="module")
def setup():
    rcfg = rconfigs.get_smoke("qwen2-0.5b")
    tcfg = tconfigs.get_smoke("qwen2-0.5b")
    rparams = rlm.init_lm(jax.random.PRNGKey(0), rcfg, jnp.float32)
    model = from_reference(jax.tree.map(np.asarray, rparams), tcfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(0, rcfg.vocab_size, n)))
               for n in LENGTHS]
    return rcfg, tcfg, rparams, model, prompts


def _tengine(setup, **kw):
    _, tcfg, _, model, _ = setup
    return ServeEngine(model, tcfg, device="cpu", **{**ENGINE_KW, **kw})


def test_greedy_tokens_identical_to_reference_engine(setup):
    """Five prompts through two slots (queueing, slot recycling, three
    buckets): the greedy tokens of both engines are identical."""
    rcfg, _, rparams, _, prompts = setup
    reng = rserve.ServeEngine(rparams, rcfg, **ENGINE_KW)
    rh = [reng.submit(p, max_new=6) for p in prompts]
    reng.run()
    teng = _tengine(setup)
    th = [teng.submit(p, max_new=6) for p in prompts]
    teng.run()
    assert [h.tokens for h in th] == [h.tokens for h in rh]
    assert teng.stats["completed"] == 5
    assert all(s is None for s in teng.slots)
    assert teng.stats["prefill_tokens"] == sum(LENGTHS)


def test_engine_equals_its_lockstep_generate(setup):
    _, tcfg, _, model, prompts = setup
    eng = _tengine(setup)
    hs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for p, h in zip(prompts, hs):
        ref = tlaunch.generate(model, tcfg, torch.tensor([p]), max_cache=64,
                               n_new=6)
        assert h.tokens == ref[0].tolist(), p


def test_bucket_for_matches_reference():
    for buckets in [(4, 8), (4, 16), (8, 16, 32, 64, 128, 256)]:
        for cap in (None, 12, 64, 300):
            for n in range(1, 300, 7):
                assert bucket_for(n, buckets, cap) == \
                    rserve.bucket_for(n, buckets, cap), (n, buckets, cap)


@pytest.mark.parametrize("prompt,max_new", [([], 4), ([1] * 60, 8)])
def test_submit_validation_errors_match(setup, prompt, max_new):
    rcfg, _, rparams, _, _ = setup
    reng = rserve.ServeEngine(rparams, rcfg, **ENGINE_KW)
    teng = _tengine(setup)
    with pytest.raises(ValueError) as re_:
        reng.submit(prompt, max_new=max_new)
    with pytest.raises(ValueError) as te_:
        teng.submit(prompt, max_new=max_new)
    assert str(te_.value) == str(re_.value)


def test_sampled_request_independent_of_slot_and_order(setup):
    """A fixed-seed sampled request draws the same tokens whether it is
    admitted first or last, alone or beside other requests."""
    _, _, _, _, prompts = setup
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=1234)
    alone = _tengine(setup)
    h0 = alone.submit(prompts[1], max_new=8, sampling=sp)
    alone.run()
    mixed = _tengine(setup)
    for p in prompts[:3]:
        mixed.submit(p, max_new=5)
    h1 = mixed.submit(prompts[1], max_new=8, sampling=sp)
    mixed.submit(prompts[4], max_new=3,
                 sampling=SamplingParams(temperature=1.0, seed=5))
    mixed.run()
    assert h1.generated == h0.generated
    assert len(set(h0.generated)) > 1


def test_top_k_one_equals_greedy(setup):
    _, _, _, _, prompts = setup
    greedy = _tengine(setup)
    g = [greedy.submit(p, max_new=6) for p in prompts[:3]]
    greedy.run()
    topk = _tengine(setup)
    sp = SamplingParams(temperature=0.7, top_k=1, seed=3)
    s = [topk.submit(p, max_new=6, sampling=sp) for p in prompts[:3]]
    topk.run()
    assert [h.tokens for h in s] == [h.tokens for h in g]


def test_cancel_frees_the_slot(setup):
    _, _, _, _, prompts = setup
    eng = _tengine(setup)
    a = eng.submit(prompts[0], max_new=20)
    b = eng.submit(prompts[1], max_new=4)
    c = eng.submit(prompts[2], max_new=4)
    eng.step()
    assert eng.cancel(a.rid)
    eng.run()
    assert a.status.value == "cancelled" and b.finished and c.finished
    assert not eng.cancel(a.rid)


def test_launcher_main_on_cpu(capsys):
    s = tlaunch.main(["--device", "cpu", "--batch", "3", "--max-slots", "2",
                      "--tokens", "4", "--prompt-len", "5"])
    out = capsys.readouterr().out
    assert "[serve] arch=qwen2-smoke" in out and "decode" in out
    assert s["completed"] == 3 and s["decode_tokens"] == 3 * 3
    assert s["device"] == "cpu"
