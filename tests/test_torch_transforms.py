"""The port's host side of serving against lap_tpu on the CPU: the native
host ops, the tokenizers, and every input and output transform.

Both packages get the same numpy inputs made from a seed. Where a transform
draws from numpy's or Python's global RNG (wrist-camera dropout, the random
base frame, the empty-image mask) or from a fresh ``np.random.default_rng()``
(prediction questions), both global RNGs are seeded identically before each
side's call and ``default_rng()`` is replaced by a seeded generator.

Tolerances: none. Token ids, masks, images, states and strings must be
identical, arrays bit for bit. The port's native resize computes as cv2's
INTER_LINEAR, which the JAX package's ``resize_with_pad_np`` calls: it is held
bit for bit against cv2 and against that function, and within the tolerance
of ``tests/test_native.py`` (median 1, mean 2 levels of 255) against the JAX
package's own native library (a double-precision bilinear).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lap_tpu import native as jax_native  # noqa: E402
from lap_tpu.models import spm as jax_spm  # noqa: E402
from lap_tpu.models import tokenizer as jax_tokenizer  # noqa: E402
from lap_tpu.policies import action_text as jax_action_text  # noqa: E402
from lap_tpu.policies import frame_transforms as jax_frames  # noqa: E402
from lap_tpu.policies import lang_action_formats as jax_formats  # noqa: E402
from lap_tpu.policies import model_transforms as jax_mt  # noqa: E402
from lap_tpu.policies import output_transforms as jax_out  # noqa: E402
from lap_tpu.policies import policy_config as jax_policy_config  # noqa: E402
from lap_tpu.policies import question_types as jax_questions  # noqa: E402
from lap_tpu.training import config as jax_config  # noqa: E402
from lap_tpu.utils import image as jax_image  # noqa: E402
from lap_tpu_torch import native  # noqa: E402
from lap_tpu_torch.models import spm, tokenizer  # noqa: E402
from lap_tpu_torch.policies import action_text, frame_transforms, lang_action_formats  # noqa: E402
from lap_tpu_torch.policies import model_transforms as mt  # noqa: E402
from lap_tpu_torch.policies import output_transforms, policy_config, question_types  # noqa: E402
from lap_tpu_torch.training import config  # noqa: E402
from lap_tpu_torch.utils import image  # noqa: E402
from torch_port_helpers import private_jax_native  # noqa: E402

PROMPTS = [
    "pick up the cup",
    "Put the red block in the bowl; then close the drawer.",
    "move forward 5 cm and rotate left 10 degrees",
    "",
    "open the top drawer and put the bowl inside",
    "stack 3 blocks 12 cm apart",
]
LANGUAGE_ACTIONS = [
    None,
    "move forward 5 cm, move left 2 cm, tilt down 10 degrees, open gripper",
    "move up 12 cm, close gripper",
    None,
    "move backward 1 cm, rotate right 25 degrees, close gripper",
    None,
]


def assert_tree_equal(got, ref, path="data"):
    """Identical nested dicts: the same keys, arrays of the same dtype,
    shape and bits, equal strings and scalars."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), f"{path}: keys {sorted(got)} != {sorted(ref)}"
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{path}/{k}")
    elif ref is None or isinstance(ref, (str, bool, int, float)):
        assert type(got) is type(ref) and got == ref, f"{path}: {got!r} != {ref!r}"
    else:
        got_a, ref_a = np.asarray(got), np.asarray(ref)
        assert got_a.dtype == ref_a.dtype and got_a.shape == ref_a.shape, f"{path}: {got_a.dtype}{got_a.shape}"
        np.testing.assert_array_equal(got_a, ref_a, err_msg=path)


def seeded(seed, fn, *args, **kw):
    """``fn`` with numpy's and Python's global RNGs seeded and every
    ``np.random.default_rng()`` without a seed drawn from ``seed``."""
    np.random.seed(seed)
    random.seed(seed)
    real = np.random.default_rng
    np.random.default_rng = lambda s=None: real(seed if s is None else s)
    try:
        return fn(*args, **kw)
    finally:
        np.random.default_rng = real


@pytest.fixture(scope="module", autouse=True)
def jax_native_in_a_private_dir(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


# ---------------------------------------------------------------------------
# Native host ops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def libs():
    lib, jax_lib = native.get_lib(), jax_native.get_lib()
    if lib is None or jax_lib is None:
        pytest.skip("g++ unavailable")
    return lib, jax_lib


def test_native_library_is_built_from_the_ports_own_source(libs):
    assert native.SOURCE.parent.parent.name == "lap_tpu_torch"
    assert native.SOURCE.read_text().count("extern \"C\"") >= 1
    assert native.status().startswith("loaded")
    assert native.LIB_PATH.parent.parent.name == "lap_tpu_torch"


@pytest.mark.parametrize("shape", [(120, 90, 3), (6, 100, 80, 3), (64, 48, 3)])
def test_native_resize_matches_the_jax_library_and_cv2(libs, shape):
    import cv2

    img = np.random.default_rng(0).integers(0, 255, shape, np.uint8)
    got = native.resize_with_pad_u8(img, 56, 56)
    jax_lib = jax_native.resize_with_pad_u8(img, 56, 56)
    diff = np.abs(got.astype(int) - jax_lib.astype(int))
    assert np.median(diff) <= 1 and diff.mean() < 2.0
    if img.ndim == 4:
        np.testing.assert_array_equal(got[0], native.resize_with_pad_u8(img[0], 56, 56))
        img, got = img[0], got[0]
    h, w = img.shape[:2]
    rh, rw = image.resized_geometry(h, w, 56, 56)
    ref = np.zeros((56, 56, 3), np.uint8)
    y0, x0 = (56 - rh) // 2, (56 - rw) // 2
    ref[y0 : y0 + rh, x0 : x0 + rw] = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(image.resize_with_pad_np(img, 56, 56), jax_image.resize_with_pad_np(img, 56, 56))


def test_native_rotate180_matches(libs):
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    np.testing.assert_array_equal(native.rotate180_u8(img), img[::-1, ::-1])
    np.testing.assert_array_equal(native.rotate180_u8(img), jax_native.rotate180_u8(img))


def test_native_unigram_matches_the_jax_library_and_python(libs):
    sp, jax_sp = spm.build_test_processor(), jax_spm.build_test_processor()
    assert sp._native is not None and jax_sp._native is not None
    for text in PROMPTS + [t for t in LANGUAGE_ACTIONS if t] + ["Task: pick up the cup; State: 12 200 49; Answer: "]:
        norm = sp._normalize(text)
        ids = sp._native.encode(norm)
        assert ids == sp._encode_unigram(norm) == jax_sp._native.encode(norm), text


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------


def _bpe_proto(module):
    pieces = [
        ("<unk>", 0.0, module.UNKNOWN), ("<s>", 0.0, module.CONTROL), ("</s>", 0.0, module.CONTROL),
        ("a", -5.0, module.NORMAL), ("b", -5.0, module.NORMAL), (module._SPACE, -5.0, module.NORMAL),
        ("ab", -1.0, module.NORMAL), ("abb", -0.5, module.NORMAL),
    ]
    return module.build_model_proto(pieces, model_type=2, add_dummy_prefix=False)


def test_spm_models_built_in_code_match():
    proto = _bpe_proto(spm)
    assert proto == _bpe_proto(jax_spm)
    sp, jax_sp = spm.SentencePieceProcessor(model_proto=proto), jax_spm.SentencePieceProcessor(model_proto=proto)
    for text in ("abb", "abab", "ba ab", "a b c"):
        assert sp.encode(text) == jax_sp.encode(text)
        assert sp.decode(sp.encode(text)) == jax_sp.decode(jax_sp.encode(text))
    test_sp, jax_test_sp = spm.build_test_processor(), jax_spm.build_test_processor()
    for text in PROMPTS + ["héllo wörld"]:
        ids = test_sp.encode(text, add_bos=True, add_eos=True)
        assert ids == jax_test_sp.encode(text, add_bos=True, add_eos=True)
        assert test_sp.decode(ids) == jax_test_sp.decode(ids)


@pytest.mark.parametrize("with_state", [False, True])
def test_paligemma_tokenize_and_decode_match(with_state):
    tok = tokenizer.PaligemmaTokenizer(max_len=64)
    ref_tok = jax_tokenizer.PaligemmaTokenizer(max_len=64)
    rng = np.random.default_rng(3)
    for prompt, lang in zip(PROMPTS, LANGUAGE_ACTIONS, strict=True):
        state = rng.uniform(-1, 1, 7).astype(np.float32) if with_state else None
        kw = dict(frame_description="end-effector frame")
        got = tok.tokenize(prompt, lang, state, **kw)
        ref = ref_tok.tokenize(prompt, lang, state, **kw)
        for g, r in zip(got, ref, strict=True):
            assert_tree_equal(g, r)
        assert tok.decode(got[0]) == ref_tok.decode(ref[0])
        assert tok.encode(prompt) == ref_tok.encode(prompt)


def test_gemma3_tokenize_matches():
    tok = tokenizer.Gemma3Tokenizer(max_len=600, num_images=2)
    ref_tok = jax_tokenizer.Gemma3Tokenizer(max_len=600, num_images=2)
    state = np.linspace(-1, 1, 7).astype(np.float32)
    for prompt, lang in zip(PROMPTS, LANGUAGE_ACTIONS, strict=True):
        for g, r in zip(tok.tokenize(prompt, lang, state), ref_tok.tokenize(prompt, lang, state), strict=True):
            assert_tree_equal(g, r)


# ---------------------------------------------------------------------------
# Input and output transforms
# ---------------------------------------------------------------------------


def raw_observation(i: int, res=(56, 56)) -> dict:
    """Raw request ``i`` of a seeded corpus. 1: no prompt; 2: no wrist
    camera; 3: an all-zero base image; even ones carry language actions and
    a raw state (the training side of CoTInputs); 5 is a prediction sample."""
    rng = np.random.default_rng(100 + i)
    obs = {"observation": {
        "base_0_rgb": rng.integers(0, 256, (*res, 3), np.uint8),
        "left_wrist_0_rgb": rng.integers(0, 256, (*res, 3), np.uint8),
        "state": rng.uniform(-1, 1, 7).astype(np.float32),
    }, "prompt": PROMPTS[i % len(PROMPTS)]}
    if i == 1:
        del obs["prompt"]
    if i == 2:
        del obs["observation"]["left_wrist_0_rgb"]
    if i == 3:
        obs["observation"]["base_0_rgb"][:] = 0
    if i % 2 == 0:
        obs["language_actions"] = rng.normal(0, 0.04, 7)
        obs["language_actions"][6] = rng.uniform(0, 1)
        quat = rng.normal(size=4)
        rot6d = np.concatenate([np.eye(3)[0] + 0.1 * quat[:3], np.eye(3)[1] - 0.1 * quat[1:]])
        obs["raw_state"] = np.concatenate([rng.normal(size=3), rot6d, [0.5]])
        obs["has_wrist_image"] = i != 2
        obs["dataset_name"] = ("droid", "jaco_play", "berkeley_autolab_ur5", "austin_buds")[i // 2 % 4]
        obs["actions"] = rng.normal(size=(4, 7)).astype(np.float32)
    if i == 5:
        obs.update(is_prediction_sample=True, language_actions=rng.normal(0, 0.04, 7),
                   raw_state=np.concatenate([rng.normal(size=3), [1, 0, 0, 0, 1, 0], [0.3]]),
                   dataset_name="bridge")
    return obs


def norm_stats(module, dim=7, seed=9):
    rng = np.random.default_rng(seed)
    q01 = rng.uniform(-2, -0.5, dim).astype(np.float32)
    stats = dict(mean=rng.normal(size=dim), std=rng.uniform(0.5, 2, dim), q01=q01,
                 q99=q01 + rng.uniform(0.5, 3, dim).astype(np.float32),
                 min=q01 - 0.5, max=q01 + 4)
    return {k: module.NormStats(**{n: np.asarray(v, np.float32) for n, v in stats.items()}) for k in ("state", "actions")}


N_RAW = 10


@pytest.fixture(scope="module")
def stacks():
    """Per config name and mode: (port stacks, JAX stacks), built as
    ``create_trained_policy`` builds them."""
    out = {}
    for name, ar, prompt in (("lap", False, "do something"), ("lap", True, None), ("debug", True, "be careful")):
        port = policy_config._build_transform_stacks(
            config.get_config(name), norm_stats(mt), default_prompt=prompt, ar=ar)
        ref = jax_policy_config._build_transform_stacks(
            jax_config.get_config(name), norm_stats(jax_mt), default_prompt=prompt, ar=ar)
        out[name, ar] = (port, ref)
    return out


@pytest.mark.parametrize("key", [("lap", False), ("lap", True), ("debug", True)], ids=str)
def test_input_stack_matches_on_raw_observations(stacks, key):
    (inputs, _), (ref_inputs, _) = stacks[key]
    port, ref = mt.compose(inputs), jax_mt.compose(ref_inputs)
    dropped = 0
    for i in range(N_RAW):
        if key == ("lap", True) and i == 1:
            with pytest.raises(ValueError, match="Prompt"):
                seeded(i, port, raw_observation(i))
            continue
        got, want = seeded(i, port, raw_observation(i)), seeded(i, ref, raw_observation(i))
        assert_tree_equal(got, want, f"request {i}")
        dropped += not got["image"]["left_wrist_0_rgb"].any()
    if key[0] == "lap":
        assert dropped >= 2  # request 2 has no wrist camera; the 0.1 dropout takes another


def test_verbose_mode_masks_match():
    port_tok, ref_tok = tokenizer.PaligemmaTokenizer(max_len=80), jax_tokenizer.PaligemmaTokenizer(max_len=80)
    port = mt.TokenizePromptAndReasoning(port_tok, discrete_state_input=True, verbose_mode=True)
    ref = jax_mt.TokenizePromptAndReasoning(ref_tok, discrete_state_input=True, verbose_mode=True)
    for i in (0, 2, 4):
        data = {"prompt": PROMPTS[i], "language_actions": LANGUAGE_ACTIONS[i] or "move up 3 cm, open gripper",
                "state": np.linspace(-1, 1, 7), "dataset_name": "droid", "frame_description": "robot base frame"}
        got, want = port(dict(data)), ref(dict(data))
        assert "critical_token_mask" in got
        assert_tree_equal(got, want)


@pytest.mark.parametrize("nt", ["normal", "bounds", "bounds_q99"])
def test_normalize_and_unnormalize_match(nt):
    rng = np.random.default_rng(4)
    data = {"state": rng.normal(size=7).astype(np.float32), "actions": rng.normal(size=(16, 7)).astype(np.float32)}
    for port_cls, ref_cls in ((mt.Normalize, jax_mt.Normalize), (mt.Unnormalize, jax_mt.Unnormalize)):
        got = port_cls(norm_stats(mt), normalization_type=nt)(dict(data))
        want = ref_cls(norm_stats(jax_mt), normalization_type=nt)(dict(data))
        assert_tree_equal(got, want)
    wide = {"actions": rng.normal(size=(4, 9)).astype(np.float32)}  # padded action dims
    assert_tree_equal(mt.Unnormalize(norm_stats(mt), normalization_type=nt)(dict(wide)),
                      jax_mt.Unnormalize(norm_stats(jax_mt), normalization_type=nt)(dict(wide)))


def test_small_transforms_match():
    rng = np.random.default_rng(5)
    imgs = {"base_0_rgb": rng.integers(0, 256, (40, 30, 3), np.uint8)}
    assert_tree_equal(mt.ResizeImages(56, 56)({"image": dict(imgs)}),
                      jax_mt.ResizeImages(56, 56)({"image": dict(imgs)}))
    state = {"state": rng.normal(size=5)}
    assert_tree_equal(mt.PadStates(7)(dict(state)), jax_mt.PadStates(7)(dict(state)))
    for data in ({}, {"prompt": "keep"}):
        assert_tree_equal(mt.InjectDefaultPrompt("default")(dict(data)),
                          jax_mt.InjectDefaultPrompt("default")(dict(data)))
    group = mt.Group(inputs=(1,), outputs=(2,)).push(inputs=(3,), outputs=(4,))
    ref = jax_mt.Group(inputs=(1,), outputs=(2,)).push(inputs=(3,), outputs=(4,))
    assert (group.inputs, group.outputs) == (ref.inputs, ref.outputs)
    nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert mt.flatten_dict(nested) == jax_mt.flatten_dict(nested)
    assert mt.unflatten_dict(mt.flatten_dict(nested)) == nested
    stats = norm_stats(mt)["state"]
    assert_tree_equal(mt.NormStats.from_dict(stats.to_dict()).to_dict(),
                      jax_mt.NormStats.from_dict(norm_stats(jax_mt)["state"].to_dict()).to_dict())


def test_detokenize_and_cot_outputs_match():
    """The AR output stack on token arrays (valid language actions, random
    ids and an empty answer), with and without a raw state (EEF frame)."""
    tok, ref_tok = tokenizer.PaligemmaTokenizer(max_len=64), jax_tokenizer.PaligemmaTokenizer(max_len=64)
    rng = np.random.default_rng(6)
    token_rows = [np.asarray(tok.encode(t), np.int32)[None] for t in LANGUAGE_ACTIONS if t]
    token_rows += [rng.integers(0, 400, (1, 12)).astype(np.int32), np.zeros((1, 5), np.int32)]
    for fmt in ("verbose_eef_with_rotation", "verbose_with_rotation"):
        port = mt.compose([mt.DetokenizeReasoning(tok), output_transforms.CoTOutputs(language_action_format=fmt)])
        ref = jax_mt.compose([jax_mt.DetokenizeReasoning(ref_tok), jax_out.CoTOutputs(language_action_format=fmt)])
        for tokens in token_rows:
            for extra in ({}, {"raw_state": np.array([0.1, 0.2, 0.3, 0.2, -0.1, 0.4, 0.5])}):
                data = {"tokens": tokens, "state": np.zeros(7, np.float32), **extra}
                assert_tree_equal(port(dict(data)), ref(dict(data)))
    vla0 = output_transforms.CoTOutputs(language_action_format="vla0_chunked", transform_strategy="vla0",
                                        norm_stats={"actions": norm_stats(mt)["actions"]})
    ref_vla0 = jax_out.CoTOutputs(language_action_format="vla0_chunked", transform_strategy="vla0",
                                  norm_stats={"actions": norm_stats(jax_mt)["actions"]})
    for text in ("500 " * 70, "1 2 3", "not ints"):
        assert_tree_equal(vla0({"reasoning": text}), ref_vla0({"reasoning": text}))
    assert_tree_equal(output_transforms.CoTOutputs()({"actions": np.ones(3)}), jax_out.CoTOutputs()({"actions": np.ones(3)}))


def test_action_text_and_frames_match():
    rng = np.random.default_rng(7)
    for _ in range(8):
        arr = rng.normal(0, 0.03, (4, 14))
        for dec in ("0f", "1f", "compact", "nearest_10", "no_number"):
            for rot in (False, True):
                text = action_text.summarize_numeric_actions(arr[:, :7], dec, include_rotation=rot)
                assert text == jax_action_text.summarize_numeric_actions(arr[:, :7], dec, include_rotation=rot)
                if dec != "compact":
                    assert action_text.describe_language_action_scale(text) == \
                        jax_action_text.describe_language_action_scale(text)
                assert action_text.is_idle_language_action(text, dec, rot) == \
                    jax_action_text.is_idle_language_action(text, dec, rot)
            assert action_text.summarize_bimanual_numeric_actions(arr, dec, True) == \
                jax_action_text.summarize_bimanual_numeric_actions(arr, dec, True)
        state10 = np.concatenate([rng.normal(size=3), [1, 0, 0, 0, 1, 0], [0.2]])
        for name in ("droid", "jaco_play", "berkeley_autolab_ur5", "austin_buds", "fmb"):
            for wrist in (False, True):
                np.testing.assert_array_equal(
                    frame_transforms.transform_actions_to_eef_frame(arr[0, :7], state10, name, wrist),
                    jax_frames.transform_actions_to_eef_frame(arr[0, :7], state10, name, wrist))
            for state in (state10, state10[:7]):
                np.testing.assert_array_equal(
                    frame_transforms.transform_actions_from_eef_frame(arr[:2, :6], state, name),
                    jax_frames.transform_actions_from_eef_frame(arr[:2, :6], state, name))


def test_language_action_formats_and_questions_match():
    rng = np.random.default_rng(8)
    texts = [t for t in LANGUAGE_ACTIONS if t] + ["move slightly left, set gripper to 0.4", "<+05 -02 +00 +10 -05 +00 1>"]
    for name in lang_action_formats.LANGUAGE_ACTION_FORMAT_REGISTRY:
        fmt, ref = lang_action_formats.get_language_action_format(name), jax_formats.get_language_action_format(name)
        for text in texts:
            for state in (None, np.array([0, 0, 0, 0.3, 0.1, -0.2, 1.0])):
                got, want = fmt.parse_language_to_deltas(text, initial_state=state), \
                    ref.parse_language_to_deltas(text, initial_state=state)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]
    vla = lang_action_formats.VLA0_CHUNKED_FORMAT
    actions = rng.uniform(-1.2, 1.2, (10, 7))
    assert vla.summarize_actions(actions) == jax_formats.VLA0_CHUNKED_FORMAT.summarize_actions(actions)
    for fmt in question_types.AnswerFormat:
        args = (*rng.normal(0, 8, 3), *rng.normal(0, 10, 3))
        ref_fmt = jax_questions.AnswerFormat(fmt.value)
        for grip in ("open gripper", "close gripper"):
            assert question_types.format_delta_motion(*args, grip, answer_format=fmt) == \
                jax_questions.format_delta_motion(*args, grip, answer_format=ref_fmt)
    assert question_types.compute_dominant_directions(3, -2, 0.5) == jax_questions.compute_dominant_directions(3, -2, 0.5)
    assert question_types.compute_gripper_change(0.1, 0.9) == jax_questions.compute_gripper_change(0.1, 0.9)
    assert question_types.compute_motion_magnitude(3, 4, 0) == jax_questions.compute_motion_magnitude(3, 4, 0)
    for name in ("droid", "bridge", "unknown_robot"):
        assert question_types.get_embodiment_name(name) == jax_questions.get_embodiment_name(name)
    cfg, ref_cfg = question_types.QuestionConfig(), jax_questions.QuestionConfig()
    for seed in range(6):
        qt = cfg.sample_question_type(np.random.default_rng(seed))
        assert qt.value == ref_cfg.sample_question_type(np.random.default_rng(seed)).value
        ref_qt = jax_questions.QuestionType(qt.value)
        assert cfg.get_prompt_template(qt, np.random.default_rng(seed), "robot base frame") == \
            ref_cfg.get_prompt_template(ref_qt, np.random.default_rng(seed), "robot base frame")
        assert cfg.sample_answer_format(np.random.default_rng(seed)).value == \
            ref_cfg.sample_answer_format(np.random.default_rng(seed)).value
