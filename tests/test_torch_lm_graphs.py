"""The language models' serving steps as ``runtime.graphs`` runners
(``launch/steps.make_prefill_step`` / ``make_decode_step``, the decode
with its cache donated) and the serve loop around them, against the JAX
package's ``jax.jit`` prefill and decode, on the CPU.

One tiny config a family (each arch's ``reduced()``: 2 layers, d=64,
float32): dense with window, softcap and scaled embeddings (gemma2), MoE,
hybrid, SSM, vision, audio. Parameters are the reference's
``lm.init_params`` draws with every all-zero leaf filled with small numpy
draws (so the vision gates open), carried over by
``convert.lm_params_from_numpy``. Prompts (and the vision and audio
states) are numpy from a seed: two batches of ``B`` then a smaller one.

The port serves as ``launch/serve.serve_lm`` does: two runners built
once, one cache slot a batch size (``lm.serve_slot``) written by each
prefill (``lm_prefill``), greedy decode steps on the slot in place
(``lm_decode``); the reference as its ``serve_lm`` does: ``jax.jit`` of
both steps, the prefill's cache padded by ``pad_kv_cache``. Held: the
greedy tokens equal, the logits of the prefill and of each decode step
and the cache at the end within 1e-4 (two layers and the unembedding
compound float32 sums in other orders); one decode step from the
reference's own cache within 1e-5 on the logits; ``keys_seen`` one a
runner over the two batches and one more for the smaller batch; the
decode returns the caller's cache object with its leaves written in
place. On the CPU the runners run eagerly, so these hold the serving
semantics; captured against eager on the card: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` phases 11-13 and 17.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro import configs as jcfgs
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.runtime import padding as jpad
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.runtime import graphs
from repro_torch.runtime import padding as tpad

E2E_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
# the prompt runs past gemma2's reduced window (32) and differs from every
# head and token count the reference's shape-based pad would catch (8)
B, S, N_DECODE = 2, 36, 6
BATCHES = (B, B, 1)            # two full batches, then a smaller one
ARCHS = ["gemma2-9b", "deepseek-moe-16b", "hymba-1.5b", "mamba2-130m",
         "llama-3.2-vision-90b", "whisper-small"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def fill_zero_leaves(tree, rng):
    """Every all-zero leaf gets small draws, so no path multiplies by 0."""
    def one(x):
        x = np.asarray(x)
        if not np.any(x):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(one, tree)


def batches_for(cfg):
    """numpy inputs of each batch of ``BATCHES``."""
    rng = np.random.default_rng(7)
    out = []
    for n in BATCHES:
        inp = {"tokens": rng.integers(0, cfg.vocab_size, (n, S), dtype=np.int32)}
        if cfg.family == "vlm":
            inp["vision"] = rng.standard_normal(
                (n, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            inp["frames"] = rng.standard_normal(
                (n, cfg.audio_frames, cfg.d_model)).astype(np.float32)
        out.append(inp)
    return out


def reference_serve(jcfg, jp, batches):
    """The reference's serve loop (``src/repro/launch/serve.py``
    ``serve_lm``): jitted steps, the cache padded, greedy decode. Per
    batch: (tokens [n, 1 + N_DECODE], logits [n, 1 + N_DECODE, V], the
    cache before each decode step, the cache at the end)."""
    prefill = jax.jit(jsteps.make_prefill_step(jcfg))
    decode = jax.jit(jsteps.make_decode_step(jcfg))
    out = []
    for inp in batches:
        logits, cache = prefill(jp, jax.tree.map(jnp.asarray, inp))
        cache = jpad.pad_kv_cache(cache, S, N_DECODE)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        toks, logits_all, before = [tok], [logits], []
        for i in range(N_DECODE):
            before.append(np_tree(cache))
            pos = jnp.full((tok.shape[0],), S + i, jnp.int32)
            logits, cache = decode(jp, cache, tok, pos)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            toks.append(tok)
            logits_all.append(logits)
        out.append((np.concatenate([np.asarray(t) for t in toks], 1),
                    np.stack([np.asarray(x) for x in logits_all], 1),
                    before, np_tree(cache)))
    return out


@pytest.fixture(scope="module")
def served():
    """Per arch: the port's config and parameters, the batches, the
    reference's serve loop, and the port's: runners built once, a slot a
    batch size, each batch's tokens, logits, the slot's leaves at the end,
    the runners' ``keys_seen`` after each batch, and whether each decode
    returned the slot itself with its leaves where they were."""
    out = {}
    for arch in ARCHS:
        jcfg = jcfgs.get_config(arch).reduced()
        tcfg = tcfgs.get_config(arch).reduced()
        jp = fill_zero_leaves(np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(3))),
                              np.random.default_rng(len(arch)))
        tp = convert.lm_params_from_numpy(jp, tcfg, device="cpu")
        batches = batches_for(jcfg)
        ref = reference_serve(jcfg, jax.tree.map(jnp.asarray, jp), batches)
        prefill, decode = tsteps.make_prefill_step(tcfg), tsteps.make_decode_step(tcfg)
        slots, port, keys, in_place = {}, [], [], []
        for inp in batches:
            n = inp["tokens"].shape[0]
            if n not in slots:
                slots[n] = tlm.serve_slot(tcfg, n, S + N_DECODE, "cpu")
            slot = slots[n]
            ptrs = {k: t.data_ptr() for k, t in slot.items()}
            t_inp = {k: torch.from_numpy(v) for k, v in inp.items()}
            logits = tserve.lm_prefill(prefill, tp, t_inp, slot)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            toks, dec_logits = tserve.lm_decode(decode, tp, slot, tok, S, N_DECODE)
            port.append((torch.cat([tok, toks], 1),
                         torch.cat([logits[:, None], dec_logits], 1),
                         {k: t.clone() for k, t in slot.items()}))
            keys.append((len(prefill.keys_seen), len(decode.keys_seen)))
            _, back = decode(tp, slot, tok, torch.full((n,), S, dtype=torch.int32))
            in_place.append(back is slot and
                            {k: t.data_ptr() for k, t in slot.items()} == ptrs)
        out[arch] = dict(tcfg=tcfg, tp=tp, ref=ref, port=port, keys=keys,
                         in_place=in_place, decode=decode, prefill=prefill)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_matches_the_jitted_reference(served, arch):
    """Each batch (two full, one smaller): greedy tokens equal, the
    prefill's and every decode step's logits and the final cache 1e-4."""
    r = served[arch]
    for (want_tok, want_logits, _, want_cache), (tok, logits, cache) in zip(
            r["ref"], r["port"]):
        np.testing.assert_array_equal(tok.numpy(), want_tok)
        close(logits, want_logits, E2E_TOL)
        assert sorted(cache) == sorted(want_cache)
        for k in want_cache:
            close(cache[k], want_cache[k], E2E_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_the_reference_cache(served, arch):
    """One decode step of the port's runner on a slot holding the
    reference's cache before that step, fed its token: logits 1e-5, at
    every step of the first batch."""
    r = served[arch]
    want_tok, want_logits, before, _ = r["ref"][0]
    decode = tsteps.make_decode_step(r["tcfg"])
    slot = tlm.serve_slot(r["tcfg"], B, S + N_DECODE, "cpu")
    for i, cache in enumerate(before):
        for k, t in slot.items():
            t.copy_(torch.from_numpy(np.array(cache[k])))
        logits, _ = decode(r["tp"], slot, torch.from_numpy(want_tok[:, i:i + 1]),
                           torch.full((B,), S + i, dtype=torch.int32))
        close(logits, want_logits[:, i + 1], STEP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_key_a_runner_and_the_cache_written_in_place(served, arch):
    """``keys_seen`` is one a runner after each of the two full batches
    (the slot reused, the prompt shape the same) and one more after the
    smaller batch (its own slot and shape); each decode returned the
    caller's slot, its leaves where they were."""
    r = served[arch]
    assert r["keys"] == [(1, 1), (1, 1), (2, 2)]
    assert r["in_place"] == [True] * len(BATCHES)
    assert r["prefill"].captures == r["decode"].captures == 0   # the CPU
    assert r["decode"].donate == (1,) and r["prefill"].donate == ()


def test_donated_argument_keys_by_identity_and_comes_back_whole():
    """``graphs.capture(donate=...)``: a donated cache joins the key by
    the identity of its tensors (another cache of the same shapes is
    another key; the same tensors in another dict the same key), is not
    copied, and the body's in-place writes reach the caller's tensors."""
    def body(params, cache, x):
        cache["k"].add_(x * params["w"])
        return x + 1, cache

    run = graphs.capture(body, donate=(1,))
    params, x = {"w": torch.full((3,), 2.0)}, torch.ones(3)
    cache = {"k": torch.zeros(3)}
    y, back = run(params, cache, x)
    assert back is cache and torch.equal(cache["k"], torch.full((3,), 2.0))
    assert run.key(params, cache, x) == run.key(params, {"k": cache["k"]}, x + 5)
    assert run.key(params, cache, x) != run.key(params, {"k": torch.zeros(3)}, x)
    assert len(run.keys_seen) == 1
    # the parameter tree may be donated too (a train step's): it comes back
    # whole, written in place, and still keys by identity
    def train(params, cache, x):
        params["w"].sub_(x)
        return params, cache, x.sum()

    run = graphs.capture(train, donate=(0, 1))
    p2, c2, s = run(params, cache, x)
    assert p2 is params and c2 is cache and float(s) == 3.0
    assert torch.equal(params["w"], torch.ones(3))
    assert run.key(params, cache, x) != run.key({"w": params["w"].clone()}, cache, x)


def test_write_kv_slot_equals_pad_kv_cache():
    """A prefill's cache written into a slot equals ``pad_kv_cache``'s
    padded copy leaf for leaf (stale entries past the prompt zeroed), for
    the hybrid and the vision caches; a batch of another size refuses."""
    for arch in ("hymba-1.5b", "llama-3.2-vision-90b"):
        cfg = tcfgs.get_config(arch).reduced()
        params = tlm.init_params(cfg, torch.Generator().manual_seed(0))
        inp = {k: torch.from_numpy(v) for k, v in batches_for(cfg)[0].items()}
        _, cache = tsteps.make_prefill_step(cfg)(params, inp)
        slot = tlm.serve_slot(cfg, B, S + 3, "cpu")
        for t in slot.values():
            t.fill_(7)                     # what a previous batch left
        tpad.write_kv_slot(slot, cache, S)
        want = tpad.pad_kv_cache(cache, S, 3)
        assert sorted(slot) == sorted(want)
        for k in want:
            assert torch.equal(slot[k], want[k]), k
        with pytest.raises(ValueError, match="does not fit"):
            tpad.write_kv_slot(tlm.serve_slot(cfg, 1, S + 3, "cpu"), cache, S)


@pytest.mark.parametrize("arch", ["gemma2-9b", "llama-3.2-vision-90b"])
def test_serve_cli_mesh_and_replicas_serve_on_one_device(capsys, arch):
    """``--mesh 1x2 --replicas 2`` on an LM: the same requests and tokens
    as without the flags (the reference's ``serve_lm`` reads neither),
    and the line saying so."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--batch-slots", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    plain = tserve.main(argv)
    out_plain = capsys.readouterr().out
    flagged = tserve.main(argv + ["--mesh", "1x2", "--replicas", "2"])
    out = capsys.readouterr().out
    assert "reads neither --mesh nor --replicas" in out
    assert "reads neither" not in out_plain
    batches = [line for line in out.splitlines() if line.startswith("[batch done]")]
    assert batches == [line for line in out_plain.splitlines()
                       if line.startswith("[batch done]")]
    assert len(batches) == 2
    for key in ("served", "tokens", "decode_steps", "graphs_captured",
                "captured_after_warmup"):
        assert flagged[key] == plain[key], key
    assert (plain["served"], plain["tokens"]) == (3.0, 9.0)
