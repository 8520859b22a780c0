"""The port's host sampler chain (a copy that imports nothing of the JAX
package) against the JAX package's: the same logits rows and the same
SamplingParams give the same token at every step. Exact equality: both are
numpy on the host with the same seeded generator."""

import dataclasses

import numpy as np
import pytest

from llama_cpp_tpu.sampling import samplers as jsp
from llama_cpp_tpu.tokenizer.vocab import Vocab as JaxVocab
from llama_cpp_tpu_torch.sampling import samplers as tsp
from llama_cpp_tpu_torch.testing import tiny_spm_vocab
from llama_cpp_tpu_torch.tokenizer.vocab import Vocab

STEPS = 50
VOCAB = 300

CASES = {
    "greedy": dict(temp=0.0),
    "default_seeded": dict(seed=7),
    "top_k": dict(seed=1, top_k=5, top_p=1.0, min_p=0.0),
    "top_p": dict(seed=2, top_k=0, top_p=0.7, min_p=0.0),
    "min_p": dict(seed=3, top_k=0, top_p=1.0, min_p=0.2),
    "temperature": dict(seed=4, temp=1.7),
    "dynatemp": dict(seed=5, temp=1.0, dynatemp_range=0.5, dynatemp_exponent=1.3),
    "repeat_penalty": dict(seed=6, penalty_repeat=1.3, penalty_last_n=16),
    "freq_presence": dict(seed=8, penalty_freq=0.4, penalty_present=0.3),
    "greedy_penalties": dict(temp=0.0, penalty_repeat=1.5, penalty_freq=0.2),
    "mirostat_v1": dict(seed=9, mirostat=1, mirostat_tau=4.0, mirostat_eta=0.2),
    "mirostat_v2": dict(seed=10, mirostat=2, mirostat_tau=3.0),
    "dry": dict(seed=11, dry_multiplier=0.8, dry_allowed_length=1, temp=0.3),
    "xtc": dict(seed=12, xtc_probability=0.5, xtc_threshold=0.05),
    "typical": dict(seed=13, typical_p=0.6),
    "top_n_sigma": dict(seed=14, top_n_sigma=1.5),
    "adaptive_p": dict(seed=15, adaptive_target=0.3),
    "logit_bias": dict(seed=16, logit_bias={3: 5.0, 7: -100.0}),
}


def logits_rows(seed: int, zipf: bool) -> np.ndarray:
    """STEPS rows over a vocab of 300: a few strong candidates among noise,
    drawn from a small set so that sequences repeat (DRY, penalties); or,
    with zipf, log-probabilities of a Zipf law in a random order (Mirostat
    v1 estimates the law's exponent, and both packages raise on a NaN where
    the estimate falls under 1, as on the first kind of row)."""
    rng = np.random.default_rng(seed)
    if zipf:
        ranks = np.stack([rng.permutation(VOCAB) for _ in range(STEPS)]) + 1
        return (-1.6 * np.log(ranks) + 0.1 * rng.normal(size=ranks.shape)).astype(np.float32)
    rows = rng.normal(size=(STEPS, VOCAB)).astype(np.float32)
    for r in rows:
        r[rng.integers(0, 12, 4)] += rng.uniform(2.0, 6.0, 4).astype(np.float32)
    return rows


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_samples_the_same_tokens(name):
    kw = CASES[name]
    md = tiny_spm_vocab(VOCAB)
    chain = tsp.SamplerChain.from_params(tsp.SamplingParams(**kw), Vocab.from_gguf(md))
    jchain = jsp.SamplerChain.from_params(jsp.SamplingParams(**kw), JaxVocab.from_gguf(md))
    assert [type(s).__name__ for s in chain.samplers] == [
        type(s).__name__ for s in jchain.samplers]
    rows = logits_rows(len(name), zipf=name == "mirostat_v1")
    got = [chain.sample(r) for r in rows]
    want = [jchain.sample(r) for r in rows]
    assert got == want
    assert chain.n_sampled == STEPS and len(set(got)) > 1
    # reset, then a second pass over the same rows: still equal
    chain.reset()
    jchain.reset()
    assert [chain.sample(r) for r in rows[:10]] == [jchain.sample(r) for r in rows[:10]]


def test_params_are_the_same_record():
    fields = [(f.name, f.default) for f in dataclasses.fields(tsp.SamplingParams)
              if f.default is not dataclasses.MISSING]
    jfields = [(f.name, f.default) for f in dataclasses.fields(jsp.SamplingParams)
               if f.default is not dataclasses.MISSING]
    assert fields == jfields


def test_gguf_sampling_defaults_apply_equally():
    md = {"general.sampling.temp": np.float32(0.3), "general.sampling.top_k": np.int32(12),
          "general.sampling.min_p": np.float32(0.01)}
    got = tsp.SamplingParams(top_k=40).apply_gguf_defaults(md, {"top_k"})
    want = jsp.SamplingParams(top_k=40).apply_gguf_defaults(md, {"top_k"})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.top_k == 40 and got.temp == pytest.approx(0.3)
