"""The port's LM ``ServeEngine`` against the JAX package's: the same
requests on the same parameters give identical tokens and the same stats,
and the slot lifecycle (admission, busy rejection, release on completion,
eviction at max_len, reset_stream) behaves as the reference's tests pin it.
f32 SMOKE configs on the CPU; prompts from numpy seeds."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke
from repro.models.lm import init_params as jax_init_params
from repro.serve import ServeEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.serve import Request, ServeEngine


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        self.t += 0.5
        return self.t


def _prompts(vocab, n, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(*lens))).astype(np.int32)
            for _ in range(n)]


def _pair(arch, seed, **kw):
    jcfg = jax_get_smoke(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    cfg = get_smoke_config(arch)
    return (cfg, ServeEngine(cfg, params, device="cpu", clock=FakeClock(),
                             **kw),
            JaxEngine(jcfg, jparams, clock=FakeClock(), **kw))


@pytest.mark.parametrize("arch,slots,n,lens,new", [
    ("llama3.2-1b", 2, 4, (3, 8), 4),
    ("qwen2-1.5b", 1, 3, (2, 5), 3),       # more requests than slots
    ("llama3.2-1b", 3, 7, (1, 12), 6),     # slots freed and reused
])
def test_tokens_and_stats_identical_to_jax(arch, slots, n, lens, new):
    cfg, eng, jeng = _pair(arch, 0, num_slots=slots, max_len=128)
    prompts = _prompts(cfg.vocab_size, n, lens, seed=n)
    reqs = [Request(prompt=p, max_new_tokens=new) for p in prompts]
    jreqs = [JaxRequest(prompt=p, max_new_tokens=new) for p in prompts]
    stats, jstats = eng.run(reqs), jeng.run(jreqs)
    assert stats == jstats
    assert stats["completed"] == n and stats["evicted"] == 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert eng.pos == jeng.pos


def test_exhaustion_evicts_like_jax():
    cfg, eng, jeng = _pair("llama3.2-1b", 3, num_slots=2, max_len=12)
    prompts = _prompts(cfg.vocab_size, 3, (2, 5), seed=9)
    reqs = [Request(prompt=p, max_new_tokens=100) for p in prompts]
    jreqs = [JaxRequest(prompt=p, max_new_tokens=100) for p in prompts]
    stats, jstats = eng.run(reqs), jeng.run(jreqs)
    assert stats == jstats and stats["evicted"] == 2
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert eng.slots == [None, None] and not any(r.done for r in reqs)


# ------------------------------------------------------- slot lifecycle
def _engine(num_slots=2, max_len=64):
    cfg, eng, _ = _pair("llama3.2-1b", 2, num_slots=num_slots,
                        max_len=max_len)
    return cfg, eng


def _req(cfg, prompt_len=2, max_new_tokens=2, seed=0):
    rng = np.random.default_rng(seed)
    return Request(prompt=rng.integers(0, cfg.vocab_size,
                                       prompt_len).astype(np.int32),
                   max_new_tokens=max_new_tokens)


def test_slot_freed_on_completion_and_reused():
    cfg, eng = _engine(num_slots=1)
    r1 = _req(cfg, prompt_len=1, max_new_tokens=1, seed=0)
    assert eng.submit(r1) and eng.slots[0] is r1
    while not r1.done:
        eng.step()
    assert eng.slots[0] is None
    r2 = _req(cfg, seed=1)
    assert eng.submit(r2) and eng.slots[0] is r2


def test_busy_rejection_and_interleaved_reuse():
    cfg, eng = _engine(num_slots=2)
    long = _req(cfg, prompt_len=1, max_new_tokens=12, seed=0)
    short = _req(cfg, prompt_len=1, max_new_tokens=2, seed=1)
    assert eng.submit(long) and eng.submit(short)
    late = _req(cfg, seed=2)
    assert not eng.submit(late) and late.out_tokens is None
    assert eng.slots == [long, short]
    while not short.done:
        eng.step()
    assert not long.done and eng.slots == [long, None]
    assert eng.submit(late) and eng.slots == [long, late]
    while not (long.done and late.done):
        eng.step()
    assert len(long.out_tokens) == 12 and len(late.out_tokens) == 2


def test_exhaustion_releases_slots_and_reset_stream_rearms():
    cfg, eng = _engine(num_slots=1, max_len=8)
    r = _req(cfg, prompt_len=4, max_new_tokens=100, seed=3)
    stats = eng.run([r])
    assert stats["completed"] == 0 and stats["evicted"] == 1
    assert not r.done and len(r.out_tokens) < r.max_new_tokens
    assert eng.pos >= eng.max_len - 1 and eng.slots == [None]
    busy = _req(cfg, prompt_len=1, max_new_tokens=1, seed=4)
    assert eng.submit(busy)
    with pytest.raises(RuntimeError, match="still occupied"):
        eng.reset_stream()
    eng.pool.release(0)
    eng.reset_stream()
    assert eng.pos == 0
    assert all(not t.any() for st in eng.cache["stages"]
               for layer in st.values() for t in layer.values())
    fresh = _req(cfg, prompt_len=1, max_new_tokens=2, seed=5)
    assert eng.run([fresh])["completed"] == 1 and fresh.done


def test_cache_written_in_place():
    cfg, eng = _engine(num_slots=1)
    k = eng.cache["stages"][0]["layer0"]["k"]
    eng.submit(_req(cfg, prompt_len=3, max_new_tokens=1, seed=6))
    eng.step()
    assert eng.cache["stages"][0]["layer0"]["k"] is k
    assert k[:, 0, 0].any() and not k[:, 0, 1:].any()


def test_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {}, num_slots=1, max_len=8)
