"""The port's profiling programs (``whisper_char_alignment_tpu_torch/scripts/
profile_*.py``) on the CPU, against the JAX package's ``scripts/profile_*.py``.

- the one-line contract: each program's ``main`` at tiny dims with
  ``WCA_PLATFORM=cpu`` prints exactly one JSON line on stdout, whose
  readings carry the JAX script's line names (less the TPU-only lines each
  port's docstring names, :data:`LEFT_OUT`, plus the lines it times in
  their place, :data:`ADDED`), each positive and finite, beside ``device``,
  ``launches`` and ``graph_captures_timed``; its lines go to stderr. The
  programs whose own knobs make them small run as ``python -m`` too;
- no fallback: without ``WCA_PLATFORM=cpu`` and without a card each exits
  non-zero before it builds a model, and prints nothing on stdout;
- the knobs' defaults (environment and flags) are the JAX scripts' module
  globals and argparse defaults, also under the tiny switches;
- parity, float32, JAX weights carried across (``params_from_jax``, every
  layer norm given a random scale and bias so that no reading is a sum of
  zero means): ``profile_decode_step.make_loop``'s ``acc`` in each of the 12
  variants against JAX ``make_loop``'s (the Pallas cross-attention in
  interpret mode) within 2e-4 relative; the all-on stripped step equal to
  ``whisper.decode_step``'s logits bit for bit; ``profile_encoder``'s
  variants against JAX ``make_encoder``'s (the Pallas encoder attention in
  interpret mode) within 2e-4; ``profile_probe_dtw.full_chunk``'s jump
  frames bit-equal to the JAX script's full chunk (its Pallas DTW kernels
  in interpret mode); the prefill's stepwise arm equal to
  ``decode_prefill``.

The JAX scripts set JAX's compilation cache when they are imported: each is
loaded with that configuration restored right after, before anything
compiles.
"""

import argparse
import dataclasses
import functools
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_char_alignment_tpu import config as jconfig
from whisper_char_alignment_tpu.align import timing as jtiming
from whisper_char_alignment_tpu.config import tiny_test_dims
from whisper_char_alignment_tpu.models import whisper as jw
from whisper_char_alignment_tpu.ops import cross_attn_pallas, dtw_pallas
from whisper_char_alignment_tpu.ops import encoder_attn_pallas
from whisper_char_alignment_tpu_torch.config import MODEL_DIMS, ModelDims
from whisper_char_alignment_tpu_torch.models import convert as tconvert
from whisper_char_alignment_tpu_torch.models import decoding as tdec
from whisper_char_alignment_tpu_torch.models import whisper as tw
from whisper_char_alignment_tpu_torch.text.tokenizer import get_test_tokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VOCAB = get_test_tokenizer().n_vocab  # >= 1602: the filters' fixed ids

# the knobs the programs read from the environment
KNOBS = ("B", "STEPS", "ITERS", "MODEL", "MODE", "KV_FRAMES", "PROMPT",
         "INT8_PALLAS", "PROF_INT8")

# tiny dims for the programs that have no tiny switch: a 30 s window
# (n_audio_ctx 1500) where the program draws 30 s of audio
TINY_1500 = tiny_test_dims(n_vocab=N_VOCAB, n_audio_ctx=1500, n_text_ctx=128,
                           state=32, head=4, layers=2)
TINY_24 = tiny_test_dims(n_vocab=N_VOCAB, n_audio_ctx=24, n_text_ctx=48,
                         state=32, head=4, layers=2)

# program -> (environment, module attributes, argv or None) of its tiny run
PROGRAMS = {
    "profile_decode_step": (dict(B="2", STEPS="3", INT8_PALLAS="1"),
                            dict(dims=TINY_24), None),
    "profile_guarded_decode": (dict(WCA_PROFILE_TINY="1", B="2", STEPS="4"),
                               {}, None),
    "profile_beam_decode": (dict(WCA_BEAM_TINY="1"), {}, None),
    "profile_prefill": (dict(WCA_PREFILL_TINY="1", B="2", STEPS="3",
                             PROMPT="12", ITERS="1"), {}, None),
    "profile_speculative": (dict(WCA_SPEC_TINY="1", WCA_SPEC_REPS="1"), {},
                            None),
    "profile_encoder": (dict(B="2"), dict(dims=TINY_24), None),
    "profile_kernels": ({}, dict(ENC_SHAPE=(2, 40, 16)),
                        ["--batch", "1", "--iters", "2"]),
    "profile_probe_dtw": ({}, {}, ["--rows", "4", "--tokens", "10",
                                   "--frames", "24", "--iters", "2"]),
    "profile_pipeline": (dict(PROF_INT8="1"), dict(DIMS=TINY_1500),
                         ["--batch", "2", "--tokens", "12", "--decode_len",
                          "3", "--frames", "30", "--iters", "1", "--reuse"]),
    "profile_e2e_overheads": (dict(B="2", ITERS="1"), dict(DIMS=TINY_1500),
                              None),
}

# the JAX script's line names at the settings above
JAX_LINES = {
    "profile_decode_step": [
        "full loop", "full loop + logit filters", "no cross-attn",
        "no self-attn", "no mlp", "no logits/argmax", "cross only",
        "empty-ish (emb+ln only)", "full loop int8 mxu",
        "full loop int8 xla-dequant", "cross only int8 mxu",
        "cross only int8 xla-dequant", "full loop int8 pallas",
        "cross only int8 pallas"],
    "profile_guarded_decode": ["exact", "int8", "guard=0 (track only)",
                               "guard=inf (full re-decode)"],
    "profile_beam_decode": ["greedy", "beam_size=5", "beam_size=5 patience=2",
                            "best_of=5 t=1.0", "sampling t=1.0"],
    "profile_prefill": ["bare sot prompt prefill", "bare sot prompt stepwise",
                        "12-token conditioning prompt prefill",
                        "12-token conditioning prompt stepwise"],
    "profile_speculative": ["exact", "spec k=2", "spec k=4", "self k=2",
                            "self k=4"],
    "profile_encoder": [
        "full (fused attn)", "full (xla attn)", "convs only (0 layers)",
        "no convs", "attn proj only (no T^2)", "no attn (mlp only)", "no mlp",
        "full, mlp flattened (B*T)", "mlp only, flattened",
        "full int8 (fused attn)", "int8 proj only (no T^2)"],
    "profile_kernels": [
        "mel XLA (DFT matmul)", "mel Pallas fused",
        "enc attn kernel block_q=256", "enc attn kernel block_q=512",
        "enc attn kernel block_q=768", "enc attn kernel KT block_q=256",
        "enc attn kernel KT block_q=512", "enc attn kernel KT block_q=1536",
        "enc attn XLA einsum"],
    # max_sub widths that divide --rows 4: none
    "profile_probe_dtw": [
        "col-normalize only", "skew only", "wavefront trace (skew+kernel)",
        "trace + per-row backtrace (old)", "trace + diag-sync scan backtrace",
        "fused wavefront+backtrace kernels",
        "full chunk (norm+fused kernels)", "full chunk bf16 stream"],
    "profile_pipeline": [
        "mel", "encoder", "greedy decode (3)", "greedy decode int8 (3)",
        "capture (enc+dec+qkpost)", "capture (xa reuse)",
        "capture (xa + cross-KV reuse)", "head-select + DTW",
        "FULL PIPELINE"],
    "profile_e2e_overheads": [
        "host WAV decode (batch)", "upload audio f32 (61 MB)",
        "upload audio i16 (31 MB)", "upload mel f16 (0 MB)", "mel (device)",
        "decode 32 steps", "encoder alone", "capture+align",
        "host retokenize (batch)"],
}
# TPU-only lines each port leaves out (its docstring says why), and the
# lines it times in their place
LEFT_OUT = {
    "profile_kernels": {
        "enc attn kernel block_q=256", "enc attn kernel block_q=512",
        "enc attn kernel block_q=768", "enc attn kernel KT block_q=256",
        "enc attn kernel KT block_q=512", "enc attn kernel KT block_q=1536"},
    "profile_probe_dtw": {"skew only", "trace + per-row backtrace (old)"},
}
ADDED = {
    "profile_kernels": {"enc attn kernel block_q=128",
                        "enc attn kernel KT block_q=128"},
}


def _port_lines(program):
    return ((set(JAX_LINES[program]) - LEFT_OUT.get(program, set()))
            | ADDED.get(program, set()))


def _module_name(program):
    return f"whisper_char_alignment_tpu_torch.scripts.{program}"


def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(("WCA_", "LAT_")) or k in KNOBS:
            monkeypatch.delenv(k)


def _port(program, monkeypatch, env=None):
    """The port's module, loaded again under ``env`` (its knobs are read
    when it is imported)."""
    _clean_env(monkeypatch)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    return importlib.reload(importlib.import_module(_module_name(program)))


def _main(mod, argv):
    return mod.main(argv) if argv is not None else mod.main()


@pytest.fixture(autouse=True)
def _knobs_restored():
    """Each port module is loaded again after a test, under the
    environment of the tests that follow."""
    yield
    for program in PROGRAMS:
        name = _module_name(program)
        if name in sys.modules:
            importlib.reload(sys.modules[name])


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_prints_one_json_line(program, monkeypatch, capsys):
    env, attrs, argv = PROGRAMS[program]
    mod = _port(program, monkeypatch, {**env, "WCA_PLATFORM": "cpu"})
    for k, v in attrs.items():
        monkeypatch.setattr(mod, k, v)
    _main(mod, argv)
    out = capsys.readouterr()
    lines = [line for line in out.out.splitlines() if line.strip()]
    assert len(lines) == 1, out.out
    payload = json.loads(lines[0])
    assert payload["program"] == program and payload["unit"] == "ms"
    readings = payload["readings"]
    assert set(readings) == _port_lines(program)
    assert all(math.isfinite(v) and v > 0 for v in readings.values()), \
        readings
    assert payload["device"] == "cpu"
    # nothing launches on the CPU; the counts are there, by kernel
    assert payload["launches"] and not any(payload["launches"].values())
    assert payload["graph_captures_timed"] == 0
    for name in readings:  # each JAX line, on stderr
        assert f"{name}: min" in out.err, name


# the programs whose own knobs make them small enough for a process here
SUBPROCESS = {
    "profile_guarded_decode": ({"WCA_PROFILE_TINY": "1", "B": "2",
                                "STEPS": "3"}, []),
    "profile_beam_decode": ({"WCA_BEAM_TINY": "1"}, []),
    "profile_prefill": ({"WCA_PREFILL_TINY": "1", "B": "2", "STEPS": "3",
                         "PROMPT": "8", "ITERS": "1"}, []),
    "profile_speculative": ({"WCA_SPEC_TINY": "1", "WCA_SPEC_KS": "2",
                             "WCA_SPEC_REPS": "1"}, []),
    "profile_kernels": ({}, ["--batch", "1", "--iters", "1", "--which",
                             "mel"]),
    "profile_probe_dtw": ({}, ["--rows", "4", "--tokens", "10", "--frames",
                               "24", "--iters", "1"]),
}


@pytest.mark.parametrize("program", sorted(SUBPROCESS))
def test_python_m_prints_one_json_line(program):
    env_add, argv = SUBPROCESS[program]
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith(("WCA_", "LAT_")) or k in KNOBS)}
    env.update(env_add, WCA_PLATFORM="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", _module_name(program), *argv],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [line for line in r.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, r.stdout
    payload = json.loads(lines[0])
    assert payload["readings"] and payload["device"] == "cpu"
    assert payload["graph_captures_timed"] == 0
    assert r.stderr.strip()


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_program_refuses_without_a_card(program, monkeypatch, capsys):
    """No ``WCA_PLATFORM=cpu`` and no card: a non-zero exit naming the
    missing card, before any model is built, and no line on stdout."""
    env, _, argv = PROGRAMS[program]
    mod = _port(program, monkeypatch, env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for builder in ("build_model", "_model"):
        if hasattr(mod, builder):
            monkeypatch.setattr(mod, builder, lambda *a: pytest.fail(
                "a model was built without a device"))
    with pytest.raises(SystemExit) as e:
        _main(mod, argv)
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


# -- the JAX scripts ---------------------------------------------------------

def _load_jax_script(program, monkeypatch, env=None):
    """The JAX package's ``scripts/<program>.py``, loaded under ``env``,
    with JAX's configuration restored as soon as it is loaded."""
    _clean_env(monkeypatch)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    # the JAX script imports a helper its config module lacks; give it one
    # for the load (the script calls it only in main)
    monkeypatch.setattr(jconfig, "medium_dims", lambda n_vocab: None,
                        raising=False)
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs", "jax_platforms")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        f"jax_{program}", os.path.join(REPO, "scripts", f"{program}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            if getattr(jax.config, k) != v:
                jax.config.update(k, v)
    return mod


# program -> the knobs held: module globals, by the port's name and JAX's
GLOBALS = {
    "profile_decode_step": ("B", "STEPS", "dims"),
    "profile_guarded_decode": ("TINY", "B", "STEPS"),
    "profile_beam_decode": ("TINY", "B", "STEPS"),
    "profile_prefill": ("B", "STEPS", "PROMPT", "ITERS"),
    "profile_speculative": ("TINY", "DECODE_LEN", "KS", "REPS"),
    "profile_encoder": ("B", "dims"),
    "profile_e2e_overheads": ("B", "ITERS"),
}
TINY_SWITCH = {"profile_guarded_decode": "WCA_PROFILE_TINY",
               "profile_beam_decode": "WCA_BEAM_TINY",
               "profile_speculative": "WCA_SPEC_TINY"}
KNOB_CASES = [(p, False) for p in sorted(GLOBALS)] + [
    (p, True) for p in sorted(TINY_SWITCH)]


def _as_dict(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("program,tiny", KNOB_CASES)
def test_knob_defaults_are_the_jax_scripts(program, tiny, monkeypatch):
    env = {TINY_SWITCH[program]: "1"} if tiny else {}
    jmod = _load_jax_script(program, monkeypatch, env)
    mod = _port(program, monkeypatch, env)
    for name in GLOBALS[program]:
        assert _as_dict(getattr(mod, name)) == _as_dict(getattr(jmod, name)), \
            name


class _Parsed(Exception):
    pass


class _Recorder(argparse.ArgumentParser):
    """An argument parser that stops its caller with the defaults."""

    def parse_args(self, args=None, namespace=None):
        raise _Parsed(vars(super().parse_args([])))


@pytest.mark.parametrize("program", ["profile_kernels", "profile_probe_dtw",
                                     "profile_pipeline"])
def test_flag_defaults_are_the_jax_scripts(program, monkeypatch):
    jmod = _load_jax_script(program, monkeypatch)
    monkeypatch.setattr(jmod, "argparse",
                        types.SimpleNamespace(ArgumentParser=_Recorder))
    with pytest.raises(_Parsed) as e:
        jmod.main()
    mod = _port(program, monkeypatch)
    assert vars(mod.parse_args([])) == e.value.args[0]


# -- parity ------------------------------------------------------------------

def _params(dims, seed):
    """JAX float32 weights, every layer norm with a random scale and bias."""
    params = jw.init_params(jax.random.PRNGKey(seed), dims)
    rng = np.random.default_rng(seed)

    def vary(path, leaf):
        last = getattr(path[-1], "key", None)
        if last == "scale":
            return leaf + 0.2 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        if last == "bias":
            return 0.2 * rng.standard_normal(leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(vary, params)


def _model(params, dims):
    return tconvert.model_from_state_dict(
        tconvert.params_from_jax(jax.tree.map(np.asarray, params)),
        ModelDims(**dataclasses.asdict(dims)), device="cpu")


def _t(tree):
    """A JAX K/V tree as torch tensors, tuples kept."""
    if isinstance(tree, (tuple, list)):
        return tuple(_t(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


STEP_DIMS = tiny_test_dims(n_vocab=N_VOCAB, n_audio_ctx=24, n_text_ctx=48,
                           state=32, head=4, layers=2)
STEP_B, STEP_STEPS = 2, 5
LOOP_VARIANTS = {
    "full loop": {},
    "full loop + logit filters": dict(filters=True),
    "no cross-attn": dict(cross=False),
    "no self-attn": dict(self_attn=False),
    "no mlp": dict(mlp=False),
    "no logits/argmax": dict(logits=False),
    "cross only": dict(self_attn=False, mlp=False, logits=False),
    "empty-ish (emb+ln only)": dict(cross=False, self_attn=False, mlp=False,
                                    logits=False),
    "full loop int8 mxu": dict(cross_impl="int8_mxu"),
    "full loop int8 xla-dequant": dict(cross_impl="int8_xla"),
    "full loop int8 pallas": dict(cross_impl="int8_pallas"),
    "cross only int8 mxu": dict(self_attn=False, mlp=False, logits=False,
                                cross_impl="int8_mxu"),
}


@pytest.fixture(scope="module")
def step_case():
    """JAX f32 weights, encoder states, float and int8 cross K/V and a
    zero cache at STEP_DIMS, on both sides (the K/V carried across, so both
    loops read the same int8 codes)."""
    params = _params(STEP_DIMS, 3)
    xa = np.random.default_rng(0).normal(
        0, 1, (STEP_B, STEP_DIMS.n_audio_ctx, STEP_DIMS.n_audio_state)
    ).astype(np.float32)
    ckv = jw.precompute_cross_kv(params, STEP_DIMS, jnp.asarray(xa))
    ckq = jw.precompute_cross_kv(params, STEP_DIMS, jnp.asarray(xa),
                                 quantize=True)
    cache = jw.init_kv_cache(STEP_DIMS, STEP_B, STEP_STEPS + 4)
    return types.SimpleNamespace(
        params=params, ckv=ckv, ckq=ckq, cache=cache,
        model=_model(params, STEP_DIMS), t_ckv=_t(ckv), t_ckq=_t(ckq),
        t_cache=_t(cache))


@pytest.mark.parametrize("variant", list(LOOP_VARIANTS))
def test_decode_step_loop_equals_jax_make_loop(variant, step_case,
                                               monkeypatch):
    """``acc`` of each variant, float32: the port's stripped loop against
    the JAX script's, within 2e-4 relative. The filtered logits hold -inf
    in both, so that variant's ``acc`` is -inf on both sides."""
    kw = LOOP_VARIANTS[variant]
    jmod = _load_jax_script("profile_decode_step", monkeypatch)
    monkeypatch.setattr(jmod, "dims", STEP_DIMS)
    monkeypatch.setattr(jmod, "B", STEP_B)
    monkeypatch.setattr(jmod, "STEPS", STEP_STEPS)
    monkeypatch.setattr(cross_attn_pallas, "cross_attn_step_int8",
                        functools.partial(
                            cross_attn_pallas.cross_attn_step_int8,
                            interpret=True))
    mod = _port("profile_decode_step", monkeypatch)
    monkeypatch.setattr(mod, "STEPS", STEP_STEPS)
    c = step_case
    int8 = kw.get("cross_impl", "bf16") != "bf16"
    want = float(jmod.make_loop(dtype=jnp.float32, **kw)(
        c.params, c.ckq if int8 else c.ckv, c.cache))
    got = float(mod.make_loop(dtype=torch.float32, **kw)(
        c.model, c.t_ckq if int8 else c.t_ckv, c.t_cache))
    if kw.get("filters"):
        assert got == want == float("-inf")
    else:
        assert math.isfinite(want) and abs(want) > 1e-5
        np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cross_impl", ["bf16", "int8_xla", "int8_mxu",
                                        "int8_pallas"])
def test_all_on_step_equals_decode_step(cross_impl, dtype, step_case):
    """The all-on stripped step's logits are ``whisper.decode_step``'s bit
    for bit, at a position with earlier cache columns filled; the stripped
    step leaves the cache as it was, the production step writes its
    column."""
    from whisper_char_alignment_tpu_torch.scripts import profile_decode_step

    dt = getattr(torch, dtype)
    model = tw.cast_params(step_case.model, dt, "cpu")
    xa = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (STEP_B, STEP_DIMS.n_audio_ctx, STEP_DIMS.n_audio_state)
    ).astype(np.float32)).to(dt)
    kv = tw.precompute_cross_kv(model, xa, quantize=cross_impl != "bf16")
    gen = torch.Generator().manual_seed(2)
    cache = tw.init_kv_cache(STEP_DIMS, STEP_B, 9, dtype=dt, device="cpu")
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen).to(dt))
    tok = torch.tensor([5, 300])
    pos = torch.tensor([4])
    before = {k: v.clone() for k, v in cache.items()}
    got = profile_decode_step.step_logits(model, tok, pos, cache, kv,
                                          cross_impl)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    want, _ = tw.decode_step(model, tok[:, None], pos, cache, kv,
                             cross_mode=profile_decode_step.CROSS_MODES[
                                 cross_impl])
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    assert not torch.equal(cache["k"][:, :, :, :, 4], before["k"][..., 4])


ENC_DIMS = tiny_test_dims(n_vocab=N_VOCAB, n_audio_ctx=24, n_text_ctx=16,
                          state=32, head=4, layers=2)
ENC_VARIANTS = {
    "full (fused attn)": {},
    "full (xla attn)": dict(attn="xla"),
    "convs only (0 layers)": dict(n_layers=0),
    "no convs": dict(convs=False),
    "attn proj only (no T^2)": dict(attn="proj_only"),
    "no attn (mlp only)": dict(attn="none"),
    "no mlp": dict(mlp=False),
    "full, mlp flattened (B*T)": dict(mlp="flat"),
    "mlp only, flattened": dict(attn="none", mlp="flat"),
}


@pytest.fixture(scope="module")
def encoder_case():
    params = _params(ENC_DIMS, 5)
    mel = np.random.default_rng(4).normal(
        0, 1, (2, ENC_DIMS.n_mels, 2 * ENC_DIMS.n_audio_ctx)).astype(
        np.float32)
    return types.SimpleNamespace(params=params, mel=mel,
                                 model=_model(params, ENC_DIMS))


@pytest.mark.parametrize("variant", list(ENC_VARIANTS))
def test_encoder_variant_equals_jax_make_encoder(variant, encoder_case,
                                                 monkeypatch):
    kw = ENC_VARIANTS[variant]
    jmod = _load_jax_script("profile_encoder", monkeypatch)
    monkeypatch.setattr(jmod, "dims", ENC_DIMS)
    monkeypatch.setattr(encoder_attn_pallas, "encoder_self_attention",
                        functools.partial(
                            encoder_attn_pallas.encoder_self_attention,
                            interpret=True))
    mod = _port("profile_encoder", monkeypatch)
    monkeypatch.setattr(mod, "dims", ENC_DIMS)
    c = encoder_case
    want = np.asarray(jmod.make_encoder(dtype=jnp.float32, **kw)(
        c.params, jnp.asarray(c.mel)))
    got = mod.make_encoder(dtype=torch.float32, **kw)(
        c.model, torch.from_numpy(c.mel)).numpy()
    assert got.shape == want.shape == (2, ENC_DIMS.n_audio_ctx,
                                       ENC_DIMS.n_audio_state)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("variant", ["full int8 (fused attn)",
                                     "int8 proj only (no T^2)"])
def test_int8_encoder_variant_equals_jax_make_encoder(variant, encoder_case,
                                                      monkeypatch):
    """The two int8 lines, on each package's ``quantize_encoder_int8`` of
    the same weights."""
    kw = {} if variant.startswith("full") else dict(attn="proj_only")
    jmod = _load_jax_script("profile_encoder", monkeypatch)
    monkeypatch.setattr(jmod, "dims", ENC_DIMS)
    monkeypatch.setattr(encoder_attn_pallas, "encoder_self_attention",
                        functools.partial(
                            encoder_attn_pallas.encoder_self_attention,
                            interpret=True))
    mod = _port("profile_encoder", monkeypatch)
    monkeypatch.setattr(mod, "dims", ENC_DIMS)
    c = encoder_case
    want = np.asarray(jmod.make_encoder(dtype=jnp.float32, **kw)(
        jw.quantize_encoder_int8(c.params), jnp.asarray(c.mel)))
    got = mod.make_encoder(dtype=torch.float32, **kw)(
        tw.quantize_encoder_int8(c.model), torch.from_numpy(c.mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_guarded_bucket_mode_prints_one_json_line(monkeypatch, capsys):
    """MODE=bucket: the frame-bucket envelope's four lines."""
    mod = _port("profile_guarded_decode", monkeypatch,
                dict(WCA_PROFILE_TINY="1", B="2", STEPS="3", MODE="bucket",
                     WCA_PLATFORM="cpu"))
    mod.main()
    out = capsys.readouterr()
    payload = json.loads(out.out)
    assert list(payload["readings"]) == [
        "exact", "bucket", "guard=0 (track only)",
        "guard=inf (full re-decode)"]
    assert payload["vs_exact"]["exact"] == 1.0
    assert "mode=bucket kv_frames=32/128" in out.err


def test_probe_dtw_full_chunk_bit_equal_to_jax(monkeypatch):
    """The full chunk's jump frames: the port (the kernels' plain versions
    here) against the JAX script's chunk (column-normalize, then the Pallas
    wavefront and backtrace in interpret mode), on the script's random maps
    with ragged lengths."""
    from whisper_char_alignment_tpu_torch.scripts import profile_probe_dtw

    rng = np.random.default_rng(0)
    b, t, f = 6, 12, 40
    maps = rng.random((b, t, f)).astype(np.float32)
    n = np.array([t - 2, t - 2, 1, t, 5, 7], np.int32)
    m = np.array([f - 8, f, 1, 9, f - 1, 20], np.int32)
    xn = jtiming._safe_col_normalize(jnp.asarray(maps))
    want = np.asarray(dtw_pallas.dtw_jump_frames_pallas(
        -xn, jnp.asarray(n), jnp.asarray(m), interpret=True))
    got = profile_probe_dtw.full_chunk(torch.from_numpy(maps),
                                       torch.from_numpy(n),
                                       torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    bf16 = profile_probe_dtw.full_chunk_bf16(
        torch.from_numpy(maps).to(torch.bfloat16), torch.from_numpy(n),
        torch.from_numpy(m))
    assert bf16.shape == got.shape and bf16.dtype == torch.int32


def test_prefill_stepwise_arm_equals_decode_prefill():
    """The stepwise arm computes what ``decode_prefill`` computes: the
    logits at the asked position and the cache, within float32 noise; and
    the whole decode gives the same tokens under either."""
    from whisper_char_alignment_tpu_torch.scripts import profile_prefill

    params = _params(STEP_DIMS, 7)
    model = _model(params, STEP_DIMS)
    xa = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (STEP_B, STEP_DIMS.n_audio_ctx, STEP_DIMS.n_audio_state)
    ).astype(np.float32))
    kv = tw.precompute_cross_kv(model, xa)
    tokens = torch.tensor([[3, 9, 27, 81, 243], [2, 4, 8, 16, 32]])
    caches = [tw.init_kv_cache(STEP_DIMS, STEP_B, 8, device="cpu")
              for _ in range(2)]
    want, _ = tw.decode_prefill(model, tokens, caches[0], kv, logits_at=3)
    got, _ = profile_prefill.stepwise_prefill(model, tokens, caches[1], kv,
                                              logits_at=3)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(caches[1]["k"], caches[0]["k"], rtol=2e-4,
                               atol=2e-4)
    mel = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (STEP_B, STEP_DIMS.n_mels, 2 * STEP_DIMS.n_audio_ctx)).astype(
        np.float32))
    opts = tdec.DecodingOptions(language="en", sample_len=4,
                                prompt=[11, 12, 13, 14, 15, 16])
    tok = get_test_tokenizer()
    plain = tdec.decode(model, tok, mel, opts, device="cpu")
    assert tw.decode_prefill is not profile_prefill.stepwise_prefill
    with profile_prefill.stepwise_prompt():
        stepped = tdec.decode(model, tok, mel, opts, device="cpu")
    assert tw.decode_prefill is not profile_prefill.stepwise_prefill
    assert [r.tokens for r in stepped] == [r.tokens for r in plain]


def test_readings_count_the_timed_calls_only(capsys):
    """``Readings.time``: one warm call, then the timed calls, whose least
    wall is the reading; launches and graph captures are counted in the
    timed calls only."""
    from whisper_char_alignment_tpu_torch.ops import _lib
    from whisper_char_alignment_tpu_torch.scripts import _profile

    r = _profile.Readings("p", torch.device("cpu"))
    calls = []

    def fn():
        calls.append(1)
        _lib.count("mel")
        if len(calls) == 1:
            r.own_captures += 1  # the warm call's capture: not timed
        if len(calls) == 3:
            r.own_captures += 1
        return len(calls)

    before = _lib.launch_counts()
    try:
        best, last = r.time("line", fn, iters=3)
    finally:
        _lib.add_launches({"mel": 1}, -len(calls))
    assert len(calls) == 4 and last == 4
    assert r.ms == {"line": best * 1e3} and best >= 0
    assert r.launches["mel"] == 3 and r.captures == 1
    assert _lib.launch_counts() == before
    payload = r.payload()
    assert payload["readings"] == r.ms and payload["device"] == "cpu"
    assert payload["graph_captures_timed"] == 1
    assert "line: min" in capsys.readouterr().err
