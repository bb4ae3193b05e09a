"""Byte-pair encoding over integer symbol streams (copy of
``lap_tpu/models/bpe.py``, its imports pointed at the port: ``encode`` goes
through ``lap_tpu_torch.native.NativeIntBPE``).

The FAST action codec (physical-intelligence/fast; reference
tokenizer.py:563-584 loads it as an HF AutoProcessor) compresses the
quantized-DCT token stream with a learned BPE vocabulary.  This module
implements that stage natively: greedy lowest-rank-first merging (the
GPT-2 algorithm) over an alphabet of quantization bins, plus a small
trainer so tests can build real vocabularies, and JSON (de)serialization
so a released vocab/merges export plugs in byte-exactly.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass
class IntBPE:
    """BPE over sequences of non-negative ints in [0, alphabet_size).

    Token ids: 0..alphabet_size-1 are the base symbols; merged tokens get
    consecutive ids in merge-creation order (rank order), exactly how a
    merges.txt-style export enumerates them.
    """

    alphabet_size: int
    # merge list in rank order: (left_id, right_id) -> new id = alphabet_size + rank
    merges: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._ranks = {tuple(pair): i for i, pair in enumerate(self.merges)}
        # expansion table: token id -> tuple of base symbols
        self._expand: list[tuple[int, ...]] = [(i,) for i in range(self.alphabet_size)]
        for left, right in self.merges:
            self._expand.append(self._expand[left] + self._expand[right])
        self._native = None  # lazily-built C++ encoder (bpe_encode)

    @property
    def vocab_size(self) -> int:
        return self.alphabet_size + len(self.merges)

    # -- apply / invert -----------------------------------------------------

    def encode(self, seq: list[int]) -> list[int]:
        """Apply merges greedily, lowest rank first (GPT-2 bpe()).

        Hot path of FAST tokenization (per-sample at pre-train batch rates):
        routed through the C++ loop in lap_tpu_torch/csrc/lap_native.cpp when available,
        with :meth:`encode_py` as the always-correct fallback (parity-tested
        in tests/test_fast_bpe.py and tests/test_torch_fast.py)."""
        if self._native is None and self.merges:
            try:
                from lap_tpu_torch.native import NativeIntBPE

                self._native = NativeIntBPE(self.merges, self.alphabet_size)
            except Exception:  # noqa: BLE001 - no toolchain: Python fallback
                self._native = False
        if self._native:
            return self._native.encode(seq)
        return self.encode_py(seq)

    def encode_py(self, seq: list[int]) -> list[int]:
        """Pure-Python reference implementation of :meth:`encode`."""
        ids = list(seq)
        if len(ids) < 2:
            return ids
        while True:
            best_rank = None
            best_pos = -1
            for i in range(len(ids) - 1):
                rank = self._ranks.get((ids[i], ids[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_pos = rank, i
            if best_rank is None:
                return ids
            new_id = self.alphabet_size + best_rank
            # merge ALL occurrences of this pair left-to-right
            out = []
            i = 0
            pair = (ids[best_pos], ids[best_pos + 1])
            while i < len(ids):
                if i < len(ids) - 1 and (ids[i], ids[i + 1]) == pair:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out

    def decode(self, ids: list[int]) -> list[int]:
        out: list[int] = []
        for t in ids:
            if 0 <= t < len(self._expand):
                out.extend(self._expand[t])
        return out

    # -- training -----------------------------------------------------------

    @classmethod
    def train(cls, corpus: list[list[int]], alphabet_size: int, num_merges: int) -> "IntBPE":
        """Classic BPE training: repeatedly merge the most frequent adjacent
        pair.  Ties break on first-seen order for determinism."""
        seqs = [list(s) for s in corpus]
        merges: list[tuple[int, int]] = []
        for rank in range(num_merges):
            counts: dict[tuple[int, int], int] = {}
            order: dict[tuple[int, int], int] = {}
            for seq in seqs:
                for a, b in zip(seq, seq[1:]):
                    pair = (a, b)
                    counts[pair] = counts.get(pair, 0) + 1
                    if pair not in order:
                        order[pair] = len(order)
            if not counts:
                break
            best = max(counts, key=lambda p: (counts[p], -order[p]))
            if counts[best] < 2:
                break
            new_id = alphabet_size + rank
            merges.append(best)
            merged_seqs = []
            for seq in seqs:
                out = []
                i = 0
                while i < len(seq):
                    if i < len(seq) - 1 and (seq[i], seq[i + 1]) == best:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(seq[i])
                        i += 1
                merged_seqs.append(out)
            seqs = merged_seqs
        return cls(alphabet_size=alphabet_size, merges=merges)

    # -- (de)serialization --------------------------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps({"alphabet_size": self.alphabet_size, "merges": self.merges})
        )

    @classmethod
    def load(cls, path: str | Path) -> "IntBPE":
        blob = json.loads(Path(path).read_text())
        return cls(
            alphabet_size=int(blob["alphabet_size"]),
            merges=[tuple(m) for m in blob["merges"]],
        )

    # Base symbols in an emitted export: one printable unicode char per
    # quantization bin, starting past ASCII so merged strings never collide
    # with the "left right" separator in merges entries.
    _EXPORT_CHAR_BASE = 0x100

    def to_hf_export(self, path: str | Path) -> None:
        """Emit a ``tokenizer.json``-shaped export of this vocabulary (the
        format ``from_hf_export`` consumes; reference consumption point
        tokenizer.py:563-584 via AutoProcessor). Round-trip proven in
        tests/test_fast_bpe.py."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)

        def sym(i: int) -> str:
            return "".join(chr(self._EXPORT_CHAR_BASE + b) for b in self._expand[i])

        vocab = {sym(i): i for i in range(self.alphabet_size)}
        merges_out = []
        for rank, (left, right) in enumerate(self.merges):
            merges_out.append(f"{sym(left)} {sym(right)}")
            vocab[sym(self.alphabet_size + rank)] = self.alphabet_size + rank
        blob = {
            "version": "1.0",
            "model": {"type": "BPE", "vocab": vocab, "merges": merges_out},
        }
        (path / "tokenizer.json").write_text(json.dumps(blob))

    @classmethod
    def from_hf_export(cls, path: str | Path) -> "IntBPE":
        """Load from a physical-intelligence/fast processor export directory.

        The export's tokenizer.json carries a byte-level BPE whose base
        alphabet enumerates quantization bins; we translate its vocab +
        merges into the integer-symbol form.  Env-gated in tests (no HF
        assets ship in this image)."""
        path = Path(path)
        blob = json.loads((path / "tokenizer.json").read_text())
        model = blob["model"]
        vocab: dict[str, int] = model["vocab"]
        # base symbols = single-character entries, densely renumbered in HF-id order
        singles = sorted((v, k) for k, v in vocab.items() if len(k) == 1)
        alphabet_size = len(singles)
        string_to_our: dict[str, int] = {k: i for i, (_, k) in enumerate(singles)}
        out_merges: list[tuple[int, int]] = []
        for rank, merge in enumerate(model["merges"]):
            left, right = merge.split(" ") if isinstance(merge, str) else merge
            out_merges.append((string_to_our[left], string_to_our[right]))
            string_to_our[left + right] = alphabet_size + rank
        return cls(alphabet_size=alphabet_size, merges=out_merges)
