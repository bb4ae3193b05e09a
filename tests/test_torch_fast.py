"""The FAST action tokens of the port (``lap_tpu_torch/models/bpe.py``,
``fast_tokenizer.py`` and ``NativeIntBPE`` in ``native.py``) against
lap_tpu's on the CPU.

Exact, no tolerance: BPE merges, encodings (the C++ loop and the Python
one), decodings and exports on the cases ``tests/test_fast_bpe.py`` builds;
the codec's symbols and its decoded actions (the same scipy DCT on both
sides); both FAST tokenizers' action ids, and the PaliGemma one's tokens
and its attention, action and loss masks, with a prompt that overflows
``max_len`` and cuts the EOS and some action tokens; ``TokenizeFASTInputs``
and ``ExtractFASTActions`` on ids inside the action range, outside it and
too few of them (the rest padded with ``num_bins // 2``). The test
vocabulary has ~150 ids, which would put the action tail below zero: as
``tests/test_fast_bpe.py`` does, both tokenizers are told the PaliGemma
vocabulary size (the id map is arithmetic on it).
"""

import json

import numpy as np
import pytest

from lap_tpu.models import bpe as jax_bpe
from lap_tpu.models import fast_tokenizer as jax_fast
from lap_tpu_torch import native as port_native
from lap_tpu_torch.models import bpe as port_bpe
from lap_tpu_torch.models import fast_tokenizer as port_fast
from torch_port_helpers import private_jax_native

VOCAB = 257_152


@pytest.fixture(scope="module", autouse=True)
def _jax_native_private(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


def _corpus(rng, n=64, lo=0, hi=16, length=24):
    out = []
    for _ in range(n):
        seq = rng.integers(lo, hi, size=length).tolist()
        seq[length // 2 :] = [lo] * (length - length // 2)
        out.append(seq)
    return out


@pytest.mark.parametrize("seed,num_merges,length", [(0, 40, 24), (1, 30, 24), (5, 60, 48)])
def test_bpe_trains_encodes_and_decodes_as_jax(seed, num_merges, length):
    rng = np.random.default_rng(seed)
    corpus = _corpus(rng, n=96, length=length)
    ours = port_bpe.IntBPE.train(corpus, alphabet_size=16, num_merges=num_merges)
    ref = jax_bpe.IntBPE.train(corpus, alphabet_size=16, num_merges=num_merges)
    assert ours.merges == ref.merges and ours.vocab_size == ref.vocab_size
    cases = corpus[:16] + _corpus(rng, n=16, length=length) + [
        [], [3], [0, 0], [0] * 40, [1, 1, 1, 1, 1], list(range(16)) * 4, rng.integers(0, 16, 50).tolist(),
    ]
    for seq in cases:
        enc = ours.encode(seq)
        assert enc == ours.encode_py(seq) == ref.encode_py(seq) == ref.encode(seq), seq
        assert ours.decode(enc) == ref.decode(enc) == list(seq)
    assert ours.decode([-1, 10_000, 3]) == ref.decode([-1, 10_000, 3])


def test_native_bpe_is_the_port_binding_and_matches_jax():
    """``IntBPE.encode`` goes through the port's ``NativeIntBPE`` (the C++
    loop of ``lap_tpu_torch/csrc/lap_native.cpp``), whose status is logged
    like the other host ops'."""
    from lap_tpu.native import NativeIntBPE as JaxNativeIntBPE

    rng = np.random.default_rng(5)
    bpe = port_bpe.IntBPE.train(_corpus(rng, n=96, length=48), alphabet_size=16, num_merges=60)
    if port_native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    assert port_native.status().startswith("loaded")
    native = port_native.NativeIntBPE(bpe.merges, bpe.alphabet_size)
    jax_native = JaxNativeIntBPE(bpe.merges, bpe.alphabet_size)
    for seq in _corpus(rng, n=32, length=48) + [[], [3], [0] * 40, list(range(16)) * 4]:
        assert native.encode(seq) == jax_native.encode(seq) == bpe.encode_py(seq)
    bpe.encode([1, 2, 3])
    assert isinstance(bpe._native, port_native.NativeIntBPE)
    dup = port_bpe.IntBPE(alphabet_size=4, merges=[(0, 1), (0, 1)])
    assert dup.encode([0, 1, 2]) == dup.encode_py([0, 1, 2]) == [5, 2]


def test_bpe_files_are_the_jax_files(tmp_path):
    rng = np.random.default_rng(3)
    corpus = _corpus(rng)
    ours = port_bpe.IntBPE.train(corpus, alphabet_size=16, num_merges=30)
    ref = jax_bpe.IntBPE.train(corpus, alphabet_size=16, num_merges=30)
    ours.save(tmp_path / "ours.json")
    ref.save(tmp_path / "ref.json")
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()
    assert port_bpe.IntBPE.load(tmp_path / "ref.json").merges == ref.merges
    ours.to_hf_export(tmp_path / "ours")
    ref.to_hf_export(tmp_path / "ref")
    assert (tmp_path / "ours" / "tokenizer.json").read_text() == (tmp_path / "ref" / "tokenizer.json").read_text()
    loaded = port_bpe.IntBPE.from_hf_export(tmp_path / "ref")
    assert loaded.merges == ref.merges and loaded.alphabet_size == 16
    (tmp_path / "hf").mkdir()
    (tmp_path / "hf" / "tokenizer.json").write_text(json.dumps(
        {"model": {"vocab": {"a": 0, "b": 1, "c": 2, "ab": 3, "abc": 4}, "merges": ["a b", "ab c"]}}))
    hf, hf_ref = port_bpe.IntBPE.from_hf_export(tmp_path / "hf"), jax_bpe.IntBPE.from_hf_export(tmp_path / "hf")
    assert hf.merges == hf_ref.merges == [(0, 1), (3, 2)] and hf.encode([0, 1, 2]) == [4]


def _codecs(seed: int, with_bpe: bool, h=8, d=7, bins=256, scale=32.0):
    rng = np.random.default_rng(seed)
    plain = port_fast.FASTActionCodec(num_bins=bins, scale=scale)
    if not with_bpe:
        return plain, jax_fast.FASTActionCodec(num_bins=bins, scale=scale), rng
    corpus = [plain.quantize(np.tanh(rng.normal(size=(h, d)) * 0.3)) for _ in range(48)]
    ours = port_bpe.IntBPE.train(corpus, alphabet_size=bins, num_merges=64)
    ref = jax_bpe.IntBPE.train(corpus, alphabet_size=bins, num_merges=64)
    return (port_fast.FASTActionCodec(num_bins=bins, scale=scale, bpe=ours),
            jax_fast.FASTActionCodec(num_bins=bins, scale=scale, bpe=ref), rng)


@pytest.mark.parametrize("with_bpe", [False, True])
def test_codec_matches_jax(with_bpe):
    ours, ref, rng = _codecs(4, with_bpe)
    assert ours.vocab_size == ref.vocab_size
    for scale in (0.3, 3.0):  # inside the bins, and clipped at their ends
        actions = np.tanh(rng.normal(size=(8, 7)) * scale).astype(np.float32) * (1 + scale)
        assert ours.quantize(actions) == ref.quantize(actions)
        toks = ours.encode(actions)
        assert toks == ref.encode(actions)
        np.testing.assert_array_equal(ours.decode(toks, action_horizon=8, action_dim=7),
                                      ref.decode(toks, action_horizon=8, action_dim=7))
        short = toks[: len(toks) // 3]
        np.testing.assert_array_equal(ours.decode(short, action_horizon=8, action_dim=7),
                                      ref.decode(short, action_horizon=8, action_dim=7))


def _tokenizers(max_len: int, *, with_bpe=False, gemma3=False):
    codec_ours, codec_ref, _ = _codecs(9, with_bpe, h=4, bins=128, scale=16.0)
    cls_ours = port_fast.Gemma3FASTTokenizer if gemma3 else port_fast.FASTTokenizer
    cls_ref = jax_fast.Gemma3FASTTokenizer if gemma3 else jax_fast.FASTTokenizer
    kw = dict(max_len=max_len, **({"num_images": 2} if gemma3 else {}))
    ours, ref = cls_ours(codec=codec_ours, **kw), cls_ref(codec=codec_ref, **kw)
    for tok in (ours, ref):
        tok._tokenizer.vocab_size = lambda: VOCAB
    return ours, ref


@pytest.mark.parametrize("cut,with_bpe", [("none", False), ("none", True), ("inside_actions", False),
                                          ("before_actions", True)])
def test_fast_tokenizer_tokens_and_masks_match_jax(cut, with_bpe):
    """Prompt + action tokens + EOS, then the cut at ``max_len`` before the
    masks: cut inside the action span, the EOS and the later action tokens
    fall off; cut before it, every action token does."""
    rng = np.random.default_rng(10)
    state = rng.uniform(-1, 1, 7).astype(np.float32)
    actions = np.tanh(rng.normal(size=(4, 7))).astype(np.float32)
    _, full_attn, full_actions, _ = _tokenizers(220, with_bpe=with_bpe)[0].tokenize_with_actions(
        "pick up the red block", state, actions)
    start = int(np.argmax(full_actions))
    max_len = {"none": 220, "inside_actions": start + 5, "before_actions": start - 3}[cut]
    ours, ref = _tokenizers(max_len, with_bpe=with_bpe)
    for acts in (actions, None):
        got = ours.tokenize_with_actions("pick up the red block", state, acts)
        want = ref.tokenize_with_actions("pick up the red block", state, acts)
        for g, w, name in zip(got, want, ("tokens", "attn", "action_mask", "loss_mask"), strict=True):
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.dtype == w.dtype and g.shape == (max_len,)
    tokens, attn, action_mask, _ = ours.tokenize_with_actions("pick up the red block", state, actions)
    if cut == "none":
        assert full_attn.sum() < 220 and action_mask.sum() == full_actions.sum() > 5
    if cut == "inside_actions":
        assert attn.all() and action_mask.sum() == 5
        assert ours._tokenizer.eos_id() not in tokens[action_mask].tolist()
    if cut == "before_actions":
        assert attn.all() and not action_mask.any()


def test_gemma3_fast_tokenizer_maps_actions_as_jax_and_has_no_prompt_path():
    ours, ref = _tokenizers(220, gemma3=True)
    actions = np.tanh(np.random.default_rng(11).normal(size=(4, 7))).astype(np.float32)
    assert ours.encode_actions(actions) == ref.encode_actions(actions)
    ids = np.asarray(ours.encode_actions(actions))
    np.testing.assert_array_equal(ours.extract_actions(ids, 4, 7), ref.extract_actions(ids, 4, 7))
    # As in JAX: the Gemma3 FAST tokenizer inherits no tokenize_with_actions.
    assert not hasattr(ours, "tokenize_with_actions") and not hasattr(ref, "tokenize_with_actions")


def test_the_fast_transforms_match_jax():
    ours, ref = _tokenizers(220, with_bpe=True)
    rng = np.random.default_rng(12)
    request = {"prompt": np.asarray("stack the cups"), "state": rng.uniform(-1, 1, 7).astype(np.float32),
               "actions": np.tanh(rng.normal(size=(4, 7))).astype(np.float32), "image": {"x": 1}}
    for data in (request, {k: v for k, v in request.items() if k != "actions"}):
        got = port_fast.TokenizeFASTInputs(ours)(dict(data))
        want = jax_fast.TokenizeFASTInputs(ref)(dict(data))
        assert set(got) == set(want) and "actions" not in got and "prompt" not in got
        for key in ("tokenized_prompt", "tokenized_prompt_mask", "tokenized_langact_mask", "token_loss_mask",
                    "state"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    no_state = port_fast.TokenizeFASTInputs(ours, discrete_state_input=False)(dict(request))
    np.testing.assert_array_equal(
        no_state["tokenized_prompt"], jax_fast.TokenizeFASTInputs(ref, discrete_state_input=False)(dict(request))[
            "tokenized_prompt"])
    with pytest.raises(ValueError, match="Prompt is required"):
        port_fast.TokenizeFASTInputs(ours)({"state": request["state"]})

    lo = VOCAB - 1 - 128 - (ours.codec.vocab_size - 1)
    hi = VOCAB - 1 - 128
    inside = ours.encode_actions(request["actions"])
    cases = {
        "in_range": np.asarray([inside]),
        "out_of_range_mixed": np.asarray([[5, lo - 1, *inside[:5], hi + 1, 1, *inside[5:], 0]]),
        "short": np.asarray([inside[: len(inside) // 2]]),
        "none_in_range": np.asarray([[0, 1, 2, hi + 5]]),
    }
    for name, tokens in cases.items():
        got = port_fast.ExtractFASTActions(ours, action_horizon=4, action_dim=7)({"tokens": tokens, "x": 1})
        want = jax_fast.ExtractFASTActions(ref, action_horizon=4, action_dim=7)({"tokens": tokens, "x": 1})
        np.testing.assert_array_equal(got["actions"], want["actions"], err_msg=name)
        assert got["actions"].shape == (4, 7) and got["x"] == 1
    flat = port_fast.FASTActionCodec(num_bins=128, scale=16.0).decode([], action_horizon=4, action_dim=7)
    np.testing.assert_array_equal(flat, np.zeros((4, 7), np.float32))  # all num_bins // 2: zero coefficients
    assert port_fast.ExtractFASTActions(ours, 4, 7)({"x": 2}) == {"x": 2}


def test_make_fast_tokenizer_picks_the_family_as_jax():
    from lap_tpu.models.lap_model import LAPConfig as JaxLAPConfig
    from lap_tpu_torch.models.lap_model import LAPConfig

    for variant in ("gemma_2b", "gemma3_4b"):
        kw = dict(paligemma_variant=variant, max_token_len=220, use_fast=True)
        ours = port_fast.make_fast_tokenizer(LAPConfig(**kw))
        ref = jax_fast.make_fast_tokenizer(JaxLAPConfig(**kw))
        assert type(ours).__name__ == type(ref).__name__
        assert ours._max_len == ref._max_len == 220 and ours.skip_tokens == ref.skip_tokens == 128
        assert ours.codec == port_fast.FASTActionCodec() and ours.codec.num_bins == ref.codec.num_bins
