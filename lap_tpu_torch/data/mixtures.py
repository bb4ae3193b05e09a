"""Named dataset mixtures (parity: lihzha/lap datasets/utils/mixtures.py).

Copied from ``lap_tpu/data/mixtures.py``; its imports point at the port's
copies.
"""

OXE_NAMED_MIXTURES: dict[str, list[tuple[str, float]]] = {
    # Pretraining mixture (reference mixtures.py:2-22): 17 members with the
    # reference's published weights.
    "oxe_magic_soup": [
        ("bc_z", 0.05),
        ("droid", 2.0),
        ("fractal20220817_data", 1.0),
        ("bridge_v2_oxe", 1.0),
        ("taco_play", 2.0),
        ("jaco_play", 1.0),
        ("furniture_bench_dataset_converted_externally_to_rlds", 0.05),
        ("utaustin_mutex", 1.0),
        ("berkeley_fanuc_manipulation", 2.0),
        ("fmb", 0.05),
        ("berkeley_autolab_ur5", 1.0),
        ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
        ("viola", 1.0),
        ("molmoact_dataset", 1.0),
    ],
    "libero_finetune": [
        ("libero_10_no_noops", 1.0),
        ("libero_spatial_no_noops", 1.0),
        ("libero_object_no_noops", 1.0),
        ("libero_goal_no_noops", 1.0),
    ],
    "bridge": [("bridge_v2_oxe", 1.0)],
    "droid": [("droid", 1.0)],
    # Back-compat aliases from round 1.
    "droid_only": [("droid", 1.0)],
    "bridge_only": [("bridge_v2_oxe", 1.0)],
}

# Individual datasets for isolated visualization/testing
# (reference mixtures.py:29-48).
for _name in (
    "bc_z",
    "fractal20220817_data",
    "bridge_v2_oxe",
    "taco_play",
    "jaco_play",
    "furniture_bench_dataset_converted_externally_to_rlds",
    "utaustin_mutex",
    "berkeley_fanuc_manipulation",
    "cmu_stretch",
    "fmb",
    "dobbe",
    "berkeley_autolab_ur5",
):
    OXE_NAMED_MIXTURES.setdefault(_name, [(_name, 1.0)])


def get_mixture(name: str) -> list[tuple[str, float]]:
    if name in OXE_NAMED_MIXTURES:
        return OXE_NAMED_MIXTURES[name]
    # Single-dataset fallback: any registered dataset by name with weight 1.
    return [(name, 1.0)]
