"""Gripper / movement helpers (numpy).

Parity with lihzha/lap ``datasets/utils/transform_helpers.py``.

Copied from ``lap_tpu/data/transform_helpers.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import numpy as np

from lap_tpu_torch.data import rotation


def compute_padded_movement_actions(eef_state: np.ndarray) -> np.ndarray:
    """action[t] = state[t+1] - state[t] (rotations via euler_diff); last = 0."""
    eef_state = np.asarray(eef_state, dtype=np.float64)
    deltas = np.concatenate(
        [
            eef_state[1:, :3] - eef_state[:-1, :3],
            rotation.euler_diff(eef_state[1:, 3:6], eef_state[:-1, 3:6]),
        ],
        axis=-1,
    )
    return np.concatenate([deltas, np.zeros((1, deltas.shape[1]))], axis=0).astype(np.float32)


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1.0 - np.asarray(actions, dtype=np.float32)


def binarize_gripper_actions(actions: np.ndarray, threshold: float = 0.95) -> np.ndarray:
    """Continuous -> binary, resolving in-between values to the NEXT
    definitive state (backward fill; octo convention)."""
    actions = np.asarray(actions, dtype=np.float32)
    open_mask = actions > threshold
    closed_mask = actions < (1 - threshold)
    in_between = ~(open_mask | closed_mask)
    is_open = open_mask.astype(np.float32)
    out = np.empty_like(is_open)
    # reference transform_helpers.py:133-161: the reverse scan starts from the
    # RAW last value, so a trailing in-between run passes it through unchanged
    carry = actions[-1]
    for i in range(len(actions) - 1, -1, -1):
        if not in_between[i]:
            carry = is_open[i]
        out[i] = carry
    return out


def rescale_action_with_bound(
    actions: np.ndarray,
    low: float,
    high: float,
    safety_margin: float = 0.0,
    post_scaling_max: float = 1.0,
    post_scaling_min: float = -1.0,
) -> np.ndarray:
    """Affine rescale [low, high] -> [post_min, post_max], clipped with a
    safety margin (reference transform_helpers.py:328-356)."""
    actions = np.asarray(actions, dtype=np.float32)
    out = (actions - low) / (high - low) * (post_scaling_max - post_scaling_min) + post_scaling_min
    return np.clip(out, post_scaling_min + safety_margin, post_scaling_max - safety_margin)


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative (+1 close, -1 open) -> absolute (0 closed, 1 open)."""
    actions = np.asarray(actions, dtype=np.float32)
    thresholded = np.where(actions < -0.1, 1, np.where(actions > 0.1, -1, 0)).astype(np.int64)
    nonzero = np.nonzero(thresholded)[0]
    start = -thresholded[nonzero[0]] if len(nonzero) else 1
    if start == 0:
        start = 1
    out = np.empty(len(actions), dtype=np.float32)
    carry = start
    for i in range(len(actions)):
        if thresholded[i] != 0:
            carry = thresholded[i]
        out[i] = carry
    return out / 2.0 + 0.5


# ---------------------------------------------------------------------------
# Empty-language-instruction fallback (reference transform_helpers.py:89-125)
# ---------------------------------------------------------------------------

# Fallback strings for datasets with empty language annotations (reference
# constants.py:8-31 FALLBACK_INSTRUCTIONS — tokenizer-visible data contract).
FALLBACK_INSTRUCTIONS: tuple[str, ...] = (
    "Do something useful.",
    "Complete the task.",
    "Perform the task.",
    "Carry out the objective.",
    "Execute the current task.",
    "Accomplish the goal.",
    "Proceed with the task.",
    "Handle the task at hand.",
    "Continue the operation.",
    "Fulfill the task.",
    "Take meaningful steps.",
    "Demonstrate useful behavior.",
    "Act in a useful manner.",
    "Engage in productive actions.",
    "Make useful moves.",
    "Undertake useful actions.",
    "Behave purposefully.",
    "Start the activity.",
)

# FarmHash Fingerprint64 (public-domain algorithm; the hash behind
# tf.strings.to_hash_bucket_fast, which the reference uses to pick the
# deterministic fallback bucket). Implemented from the published farmhashna
# spec for inputs <= 64 bytes — "%.6f"-formatted float32 sums never exceed
# ~48 characters.
_K0 = 0xC3A5C85C97CB3127
_K1 = 0xB492B66FBE98F273
_K2 = 0x9AE16A3B2F90404F
_M64 = (1 << 64) - 1


def _rot(v: int, n: int) -> int:
    return ((v >> n) | (v << (64 - n))) & _M64


def _shift_mix(v: int) -> int:
    return (v ^ (v >> 47)) & _M64


def _fetch64(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 8], "little")


def _fetch32(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 4], "little")


def _hash16(u: int, v: int, mul: int) -> int:
    a = ((u ^ v) * mul) & _M64
    a ^= a >> 47
    b = ((v ^ a) * mul) & _M64
    b ^= b >> 47
    return (b * mul) & _M64


def farmhash_fingerprint64(s: bytes) -> int:
    n = len(s)
    if n <= 16:
        if n >= 8:
            mul = (_K2 + n * 2) & _M64
            a = (_fetch64(s, 0) + _K2) & _M64
            b = _fetch64(s, n - 8)
            c = (_rot(b, 37) * mul + a) & _M64
            d = ((_rot(a, 25) + b) * mul) & _M64
            return _hash16(c, d, mul)
        if n >= 4:
            mul = (_K2 + n * 2) & _M64
            a = _fetch32(s, 0)
            return _hash16((n + (a << 3)) & _M64, _fetch32(s, n - 4), mul)
        if n > 0:
            y = (s[0] + (s[n >> 1] << 8)) & _M64
            z = (n + (s[n - 1] << 2)) & _M64
            return (_shift_mix((y * _K2 ^ z * _K0) & _M64) * _K2) & _M64
        return _K2
    if n <= 32:
        mul = (_K2 + n * 2) & _M64
        a = (_fetch64(s, 0) * _K1) & _M64
        b = _fetch64(s, 8)
        c = (_fetch64(s, n - 8) * mul) & _M64
        d = (_fetch64(s, n - 16) * _K2) & _M64
        return _hash16(
            (_rot((a + b) & _M64, 43) + _rot(c, 30) + d) & _M64,
            (a + _rot((b + _K2) & _M64, 18) + c) & _M64,
            mul,
        )
    if n <= 64:
        mul = (_K2 + n * 2) & _M64
        a = (_fetch64(s, 0) * _K2) & _M64
        b = _fetch64(s, 8)
        c = (_fetch64(s, n - 8) * mul) & _M64
        d = (_fetch64(s, n - 16) * _K2) & _M64
        y = (_rot((a + b) & _M64, 43) + _rot(c, 30) + d) & _M64
        z = _hash16(y, (a + _rot((b + _K2) & _M64, 18) + c) & _M64, mul)
        e = (_fetch64(s, 16) * mul) & _M64
        f = _fetch64(s, 24)
        g = ((y + _fetch64(s, n - 32)) * mul) & _M64
        h = ((z + _fetch64(s, n - 24)) * mul) & _M64
        return _hash16(
            (_rot((e + f) & _M64, 43) + _rot(g, 30) + h) & _M64,
            (e + _rot((f + a) & _M64, 18) + g) & _M64,
            mul,
        )
    raise ValueError(f"farmhash_fingerprint64: {n}-byte input > 64 unsupported")


def fill_empty_instructions(
    instructions: list[str],
    first_state: np.ndarray,
    *,
    deterministic: bool = True,
) -> list[str]:
    """Reference ``fill_empty_language_instruction`` semantics: look at the
    FIRST step's instruction; pick a fallback when it is empty/whitespace;
    then broadcast the selected string (original or fallback) to EVERY step.

    Deterministic bucket = Fingerprint64("%.6f" % sum(state[0])) mod 18 —
    byte-identical to ``tf.strings.to_hash_bucket_fast(tf.strings.as_string(
    tf.reduce_sum(state[0])), 18)``. The reference's non-deterministic
    variant (austin_sirius, ``tf.random.shuffle``) draws from the global TF
    seed; this rebuild keeps the pipeline bitwise reproducible by salting
    the same state hash instead — a documented divergence in WHICH of the
    18 strings is chosen, never in WHETHER filling happens.
    """
    first = instructions[0] if instructions else ""
    if first.strip():
        selected = first
    else:
        ssum = np.asarray(first_state, np.float32).sum(dtype=np.float32)
        key = (b"sirius:" if not deterministic else b"") + (b"%.6f" % float(ssum))
        selected = FALLBACK_INSTRUCTIONS[
            farmhash_fingerprint64(key) % len(FALLBACK_INSTRUCTIONS)
        ]
    return [selected] * max(len(instructions), 1)
