"""PyTorch port: `serve --arch` for the families beyond dense and hybrid
(RWKV6, MoE with the sliding-window ring, MoE with MLA, the patch and
frame stub frontends) on the CPU at reduced size.

What the wave loop hands the model is checked here: integer prompts and
greedy tokens for token frontends; for the stub frontends 0.02·N(0, 1)
embeddings [admit, prompt_len, d_model] and one fixed embedding
[admit, d_model] fed at every decode step of a wave, as the reference's
wave loop does.  The models themselves are held to the reference in
test_torch_models.py and the per-family files.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.launch import steps as S


@pytest.fixture
def calls(monkeypatch):
    """Every prefill and decode input of the wave loop, recorded."""
    seen = {"prefill": [], "decode": []}
    make_prefill, make_decode = S.make_prefill_step, S.make_decode_step

    def prefill_step(cfg, max_seq):
        fn = make_prefill(cfg, max_seq)
        return lambda params, toks: (seen["prefill"].append(toks),
                                     fn(params, toks))[1]

    def decode_step(cfg):
        fn = make_decode(cfg)
        return lambda params, cache, tok, pos: (
            seen["decode"].append((tok, pos)), fn(params, cache, tok,
                                                  pos))[1]

    monkeypatch.setattr(serve.S, "make_prefill_step", prefill_step)
    monkeypatch.setattr(serve.S, "make_decode_step", decode_step)
    return seen


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "chameleon-34b",
                                  "musicgen-large"])
def test_serve_each_new_family_on_cpu(arch, calls):
    batch, plen, gen, waves = 3, 16, 3, 2
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", str(batch), "--prompt-len", str(plen),
                      "--gen", str(gen), "--waves", str(waves)])
    assert math.isfinite(res["p50"]) and res["p99"] >= res["p50"] > 0
    assert len(res["prefill_ms"]) == len(res["admitted"]) == waves
    d_model = 128
    stub = get_arch(arch).frontend != "token"
    assert len(calls["prefill"]) == waves
    assert len(calls["decode"]) == waves * gen
    for w, (prompts, admit) in enumerate(zip(calls["prefill"],
                                             res["admitted"])):
        steps = calls["decode"][w * gen:(w + 1) * gen]
        assert [pos for _, pos in steps] == list(range(plen, plen + gen))
        if stub:
            assert prompts.dtype == torch.float32
            assert prompts.shape == (admit, plen, d_model)
            assert 0.015 < float(prompts.std()) < 0.025
            frame = steps[0][0]
            assert frame.shape == (admit, d_model)
            assert all(tok is frame for tok, _ in steps)
        else:
            assert prompts.dtype == torch.int64
            assert prompts.shape == (admit, plen)
            assert all(tok.shape == (admit,) and not tok.is_floating_point()
                       for tok, _ in steps)
