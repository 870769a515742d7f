"""The port's LM serving loop and command line against the JAX reference's
``serve_lm`` (``src/repro/launch/serve.py``), on the CPU.

The port's loop, fed the reference's weights (``lm_from_numpy``) and the
same numpy prompts, generates the reference's greedy tokens at
``compute_dtype=float32``.  In bf16 the two round at other places (see
``tests/test_torch_models.py``), so a near tie may pick another token
after a few steps: the first token must be the same, and each step's
logits, teacher-forced on the reference's tokens, lie within 6e-2.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models.transformer import LM as JLM
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models.convert import lm_from_numpy

torch.set_num_threads(1)

LINE = re.compile(r"\[serve\] (\S+): generated (\d+) tokens x(\d+) in "
                  r"([\d.]+) ms \((\d+) tok/s\)")


def _reference_loop(jm, params, prompts, gen_len):
    """``serve_lm``'s loop (prefill, pad, greedy decode) for any config,
    with the logits of every step."""
    p = prompts.shape[1]
    logits, (k, v) = jax.jit(jm.prefill)(params, jnp.asarray(prompts))
    pad = ((0, 0), (0, 0), (0, gen_len), (0, 0), (0, 0))
    cache = (jnp.pad(k, pad), jnp.pad(v, pad))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks, steps = [tok], [logits]
    for i in range(gen_len):
        logits, cache = jm.decode_step(params, cache, tok,
                                       jnp.array(p + i, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(tok)
        steps.append(logits)
    return np.asarray(jnp.concatenate(toks, 1)), [np.asarray(s)
                                                  for s in steps]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minitron-4b"])
def test_serve_lm_greedy_tokens_f32(arch, capsys):
    jcfg = dataclasses.replace(jconfigs.get(arch).make_reduced(),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(configs.get(arch).make_reduced(),
                               compute_dtype=torch.float32)
    jm = JLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (4, 32))
    want, _ = _reference_loop(jm, params, prompts.astype(np.int32), 16)
    lm = lm_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    got = serve.serve_lm(arch, batch=4, prompt_len=32, gen_len=16, seed=0,
                         device="cpu", lm=lm)
    assert got.dtype == np.int32 and got.shape == (4, 17)
    np.testing.assert_array_equal(got, want)
    assert LINE.search(capsys.readouterr().out)


def test_serve_lm_bf16_against_reference(capsys):
    """The reference's own ``serve_lm`` (bf16, its weights from its seed)
    against the port's loop on those weights."""
    arch, seed = "qwen3-1.7b", 0
    want = jserve.serve_lm(arch, batch=4, prompt_len=32, gen_len=16,
                           seed=seed)
    jm = JLM(jconfigs.get(arch).make_reduced())
    params = jm.init(jax.random.PRNGKey(seed))
    lm = lm_from_numpy(configs.get(arch).make_reduced(),
                       jax.tree.map(np.asarray, params), device="cpu")
    got = serve.serve_lm(arch, batch=4, prompt_len=32, gen_len=16,
                         seed=seed, device="cpu", lm=lm)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    # teacher-forced on the reference's tokens, step by step
    prompts = np.random.default_rng(seed).integers(0, jm.cfg.vocab, (4, 32))
    toks, jlogits = _reference_loop(jm, params, prompts.astype(np.int32), 16)
    np.testing.assert_array_equal(toks, want)
    tlog, cache = lm.prefill(torch.as_tensor(prompts), cache_len=48)
    np.testing.assert_allclose(tlog.numpy(), jlogits[0], atol=6e-2,
                               rtol=6e-2)
    for i in range(16):
        tlog, cache = lm.decode_step(cache, torch.tensor(
            toks[:, i:i + 1], dtype=torch.long), 32 + i)
        np.testing.assert_allclose(tlog.numpy(), jlogits[i + 1], atol=6e-2,
                                   rtol=6e-2)


def test_serve_cli_prints_reference_fields(capsys):
    jserve.serve_lm("qwen3-1.7b", batch=2, gen_len=4)
    ref_line = LINE.search(capsys.readouterr().out)
    toks = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--gen-len", "4"])
    line = LINE.search(capsys.readouterr().out)
    assert ref_line and line
    assert line.group(1, 2, 3) == ref_line.group(1, 2, 3) \
        == ("qwen3-1.7b", "4", "2")
    assert toks.shape == (2, 5)
    again = serve.serve_lm("qwen3-1.7b", batch=2, gen_len=4, device="cpu")
    np.testing.assert_array_equal(again, toks)        # seeded


def test_serve_cli_refuses_unported():
    """The MoE LMs still raise (A11); trim-stream and wide-deep, which
    raised before they were ported, now serve."""
    engine = serve.main(["--app", "trim-stream", "--graph", "chain",
                         "--ticks", "2", "--update-batch", "8",
                         "--device", "cpu"])
    assert engine.compactions == 0 and engine.delta.n == 2_000
    scores = serve.main(["--arch", "wide-deep", "--smoke", "--device", "cpu"])
    assert scores.shape == (4,) and np.isfinite(scores).all()
    with pytest.raises(NotImplementedError, match="A11"):
        serve.main(["--arch", "arctic-480b", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu"])         # no --arch
    with pytest.raises(SystemExit, match="lm/recsys"):     # as the reference
        serve.main(["--arch", "schnet", "--smoke", "--device", "cpu"])
