"""SentencePiece-compatible tokenizer codec, from scratch.

The reference stack depends on the ``sentencepiece`` C++ wheel
(lihzha/lap ``tokenizer.py:43-48``) to load
``gs://big_vision/paligemma_tokenizer.model``. This module re-implements the
parts LAP uses with no external dependency:

- a minimal protobuf wire-format parser for ModelProto (pieces + scores +
  types, trainer/normalizer options),
- BPE encoding (merge-rank = piece score) and unigram (Viterbi) encoding,
- byte-fallback for out-of-vocab characters,
- decode / id_to_piece / piece_to_id / pad_id / bos_id / eos_id / unk_id.

Works with any sentencepiece ``.model`` file placed on disk; unit tests build
a tiny model proto by hand.

Copied from ``lap_tpu/models/spm.py``; its imports point at the port's
copies.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

_SPACE = "▁"  # sentencepiece word-boundary marker

# SentencePiece piece types.
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
BYTE = 6
UNUSED = 5


# ---------------------------------------------------------------------------
# Protobuf wire parsing (just enough for ModelProto)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val = buf[i : i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


@dataclasses.dataclass
class _Piece:
    piece: str
    score: float
    type: int


def _parse_sentencepiece(buf: bytes) -> _Piece:
    import struct

    piece, score, ptype = "", 0.0, NORMAL
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            piece = val.decode("utf-8")
        elif field == 2:
            score = struct.unpack("<f", val)[0]
        elif field == 3:
            ptype = val
    return _Piece(piece, score, ptype)


def _parse_model_proto(buf: bytes):
    pieces: list[_Piece] = []
    trainer: dict = {}
    normalizer: dict = {}
    for field, _wire, val in _iter_fields(buf):
        if field == 1:  # repeated SentencePiece
            pieces.append(_parse_sentencepiece(val))
        elif field == 2:  # TrainerSpec
            for f2, _w2, v2 in _iter_fields(val):
                if f2 == 3:  # model_type: 1=unigram 2=bpe
                    trainer["model_type"] = v2
                elif f2 == 40:
                    trainer["unk_id"] = v2
                elif f2 == 41:
                    trainer["bos_id"] = v2
                elif f2 == 42:
                    trainer["eos_id"] = v2
                elif f2 == 43:
                    trainer["pad_id"] = v2
                elif f2 == 35:
                    trainer["byte_fallback"] = bool(v2)
        elif field == 3:  # NormalizerSpec
            for f3, _w3, v3 in _iter_fields(val):
                if f3 == 3:
                    normalizer["add_dummy_prefix"] = bool(v3)
                elif f3 == 4:
                    normalizer["remove_extra_whitespaces"] = bool(v3)
                elif f3 == 6:
                    normalizer["escape_whitespaces"] = bool(v3)
    return pieces, trainer, normalizer


# ---------------------------------------------------------------------------
# The processor
# ---------------------------------------------------------------------------


class SentencePieceProcessor:
    """Drop-in for the subset of sentencepiece.SentencePieceProcessor LAP uses."""

    def __init__(
        self, *, model_proto: bytes | None = None, model_file: str | Path | None = None
    ):
        if model_proto is None:
            model_proto = Path(model_file).read_bytes()
        pieces, trainer, normalizer = _parse_model_proto(model_proto)
        self._pieces = pieces
        self._piece_to_id = {p.piece: i for i, p in enumerate(pieces)}
        self._model_type = trainer.get("model_type", 1)
        self._unk_id = trainer.get("unk_id", 0)
        self._bos_id = trainer.get("bos_id", 1)
        self._eos_id = trainer.get("eos_id", 2)
        self._pad_id = trainer.get("pad_id", -1)
        self._byte_fallback = trainer.get("byte_fallback", False)
        self._add_dummy_prefix = normalizer.get("add_dummy_prefix", True)
        self._byte_ids = {}
        for i, p in enumerate(pieces):
            if p.type == BYTE:
                # pieces look like "<0x0A>"
                self._byte_ids[int(p.piece[1:-1], 16)] = i
        # Optional C++ Viterbi hot loop (csrc/lap_native.cpp).
        self._native = None
        if self._model_type != 2 and not self._byte_fallback:
            try:
                from lap_tpu_torch import native as _native_mod
                import numpy as _np

                self._native = _native_mod.NativeUnigramVocab(
                    [p.piece for p in pieces],
                    _np.array([p.score for p in pieces], _np.float32),
                    _np.array(
                        [p.type in (NORMAL, USER_DEFINED) for p in pieces], _np.uint8
                    ),
                    self._unk_id,
                )
            except Exception:  # noqa: BLE001 - fall back to Python
                self._native = None

    # -- info ---------------------------------------------------------------
    def vocab_size(self) -> int:
        return len(self._pieces)

    def pad_id(self) -> int:
        return self._pad_id

    def bos_id(self) -> int:
        return self._bos_id

    def eos_id(self) -> int:
        return self._eos_id

    def unk_id(self) -> int:
        return self._unk_id

    def id_to_piece(self, idx: int) -> str:
        return self._pieces[idx].piece

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self._unk_id)

    # -- encoding -----------------------------------------------------------
    def _normalize(self, text: str) -> str:
        text = " ".join(text.split()) if text else text
        if self._add_dummy_prefix:
            text = " " + text
        return text.replace(" ", _SPACE)

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        norm = self._normalize(text)
        if self._model_type == 2:
            ids = self._encode_bpe(norm)
        elif self._native is not None:
            ids = self._native.encode(norm)
        else:
            ids = self._encode_unigram(norm)
        if add_bos:
            ids = [self._bos_id, *ids]
        if add_eos:
            ids = [*ids, self._eos_id]
        return ids

    def _char_ids(self, text: str) -> list[tuple[str, int | None]]:
        """Initial symbol sequence: single chars (or byte-fallback pieces)."""
        out = []
        for ch in text:
            if ch in self._piece_to_id:
                out.append((ch, self._piece_to_id[ch]))
            elif self._byte_fallback:
                for b in ch.encode("utf-8"):
                    out.append((self._pieces[self._byte_ids[b]].piece, self._byte_ids[b]))
            else:
                out.append((ch, self._unk_id))
        return out

    def _encode_bpe(self, text: str) -> list[int]:
        """Greedy highest-score merge (sentencepiece BPE semantics)."""
        symbols = self._char_ids(text)
        if not symbols:
            return []
        while True:
            best = None
            for i in range(len(symbols) - 1):
                merged = symbols[i][0] + symbols[i + 1][0]
                mid = self._piece_to_id.get(merged)
                if mid is None or self._pieces[mid].type != NORMAL:
                    continue
                score = self._pieces[mid].score
                if best is None or score > best[0]:
                    best = (score, i, merged, mid)
            if best is None:
                break
            _, i, merged, mid = best
            symbols[i : i + 2] = [(merged, mid)]
        return [self._unk_id if sid is None else sid for _s, sid in symbols]

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi segmentation maximizing sum of piece log-probs."""
        n = len(text)
        if n == 0:
            return []
        NEG = -1e18
        best_score = [NEG] * (n + 1)
        best_path: list[tuple[int, int] | None] = [None] * (n + 1)
        best_score[0] = 0.0
        max_piece_len = max((len(p.piece) for p in self._pieces), default=1)
        unk_penalty = min((p.score for p in self._pieces if p.type == NORMAL), default=-10.0) - 10.0
        for i in range(n):
            if best_score[i] <= NEG / 2:
                continue
            upper = min(n, i + max_piece_len)
            matched = False
            for j in range(i + 1, upper + 1):
                pid = self._piece_to_id.get(text[i:j])
                if pid is None or self._pieces[pid].type not in (NORMAL, USER_DEFINED):
                    continue
                matched = True
                s = best_score[i] + self._pieces[pid].score
                if s > best_score[j]:
                    best_score[j] = s
                    best_path[j] = (i, pid)
            if not matched or best_score[i + 1] <= NEG / 2:
                # unk/byte fallback for a single char
                ch = text[i]
                if self._byte_fallback and ch not in self._piece_to_id:
                    bts = ch.encode("utf-8")
                    s = best_score[i] + sum(
                        self._pieces[self._byte_ids[b]].score for b in bts
                    )
                    if s > best_score[i + 1]:
                        best_score[i + 1] = s
                        best_path[i + 1] = (i, tuple(self._byte_ids[b] for b in bts))
                else:
                    s = best_score[i] + unk_penalty
                    if s > best_score[i + 1]:
                        best_score[i + 1] = s
                        best_path[i + 1] = (i, self._unk_id)
        # Backtrack
        ids: list[int] = []
        j = n
        while j > 0:
            i, pid = best_path[j]
            if isinstance(pid, tuple):
                ids[:0] = list(pid)
            else:
                ids.insert(0, pid)
            j = i
        return ids

    # -- decoding -----------------------------------------------------------
    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for idx in ids:
            if idx < 0 or idx >= len(self._pieces):
                continue
            p = self._pieces[idx]
            if p.type == BYTE:
                byte_buf.append(int(p.piece[1:-1], 16))
                continue
            flush()
            if p.type in (CONTROL, UNKNOWN):
                continue
            out.append(p.piece)
        flush()
        text = "".join(out).replace(_SPACE, " ")
        return text[1:] if text.startswith(" ") and self._add_dummy_prefix else text


# ---------------------------------------------------------------------------
# Test-model builder (wire-format writer) — used by unit tests and the
# deterministic fallback tokenizer.
# ---------------------------------------------------------------------------


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((num << 3) | wire) + payload


def build_model_proto(
    pieces: list[tuple[str, float, int]],
    *,
    model_type: int = 1,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
    byte_fallback: bool = False,
    add_dummy_prefix: bool = True,
) -> bytes:
    import struct

    buf = bytearray()
    for piece, score, ptype in pieces:
        sp = bytearray()
        pb = piece.encode("utf-8")
        sp += _field(1, 2, _write_varint(len(pb)) + pb)
        sp += _field(2, 5, struct.pack("<f", score))
        sp += _field(3, 0, _write_varint(ptype))
        buf += _field(1, 2, _write_varint(len(sp)) + bytes(sp))
    tr = bytearray()
    tr += _field(3, 0, _write_varint(model_type))
    tr += _field(35, 0, _write_varint(int(byte_fallback)))
    tr += _field(40, 0, _write_varint(unk_id))
    tr += _field(41, 0, _write_varint(bos_id))
    tr += _field(42, 0, _write_varint(eos_id))
    # pad_id may be -1; protobuf varints encode negatives as 10 bytes
    tr += _field(43, 0, _write_varint(pad_id & 0xFFFFFFFFFFFFFFFF) if pad_id < 0 else _write_varint(pad_id))
    buf += _field(2, 2, _write_varint(len(tr)) + bytes(tr))
    nm = bytearray()
    nm += _field(3, 0, _write_varint(int(add_dummy_prefix)))
    buf += _field(3, 2, _write_varint(len(nm)) + bytes(nm))
    return bytes(buf)


def build_test_processor(extra_words: list[str] | None = None) -> SentencePieceProcessor:
    """A small deterministic tokenizer covering ASCII + common LAP words.

    Used when the real PaliGemma tokenizer model file is unavailable (e.g.
    offline test environments). Vocabulary: specials, single characters with
    word-boundary variants, and whole common words.
    """
    words = [
        "Task", "State", "Answer", "move", "forward", "backward", "left",
        "right", "up", "down", "tilt", "rotate", "close", "open", "gripper",
        "cm", "degrees", "the", "robot", "and", "pick", "place",
    ] + (extra_words or [])
    pieces: list[tuple[str, float, int]] = [
        ("<unk>", 0.0, UNKNOWN),
        ("<s>", 0.0, CONTROL),
        ("</s>", 0.0, CONTROL),
        ("<pad>", 0.0, CONTROL),
    ]
    chars = (
        [chr(c) for c in range(32, 127)]
    )
    for ch in chars:
        c = _SPACE if ch == " " else ch
        pieces.append((c, -10.0, NORMAL))
    for w in words:
        pieces.append((_SPACE + w, -1.0, NORMAL))
        pieces.append((w, -2.0, NORMAL))
    for d in "0123456789":
        pieces.append((_SPACE + d, -3.0, NORMAL))
    proto = build_model_proto(
        [  # dedupe, keep first
            p for i, p in enumerate(pieces) if p[0] not in {q[0] for q in pieces[:i]}
        ],
        model_type=1,
        unk_id=0,
        bos_id=1,
        eos_id=2,
        pad_id=3,
    )
    return SentencePieceProcessor(model_proto=proto)
