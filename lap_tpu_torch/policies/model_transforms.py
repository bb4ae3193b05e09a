"""Transform composition (the port's own copy of ``compose`` from
``lap_tpu/policies/model_transforms.py``; the transforms themselves are not
ported yet)."""

from __future__ import annotations

from collections.abc import Callable, Sequence


def compose(transforms: Sequence[Callable[[dict], dict]]) -> Callable[[dict], dict]:
    def run(data: dict) -> dict:
        for t in transforms:
            data = t(data)
        return data

    return run
