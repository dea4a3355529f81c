"""Class label maps (own copy of ``mla_tpu/data/labels.py``): the serving
fronts label their top-k with these names; AudioSet uses the
``class_labels_indices.csv`` ontology file with 527 rows of (index, mid,
display_name).

No network in this environment, so the real CSV must be provided by the
user; synthetic datasets get generated names. ESC-50 and UrbanSound8K class
name lists are small, public, and included inline.
"""

from __future__ import annotations

import csv
from typing import List, Optional

ESC50_LABELS: List[str] = [
    "dog", "rooster", "pig", "cow", "frog", "cat", "hen", "insects", "sheep",
    "crow", "rain", "sea_waves", "crackling_fire", "crickets", "chirping_birds",
    "water_drops", "wind", "pouring_water", "toilet_flush", "thunderstorm",
    "crying_baby", "sneezing", "clapping", "breathing", "coughing", "footsteps",
    "laughing", "brushing_teeth", "snoring", "drinking_sipping", "door_knock",
    "mouse_click", "keyboard_typing", "door_wood_creaks", "can_opening",
    "washing_machine", "vacuum_cleaner", "clock_alarm", "clock_tick",
    "glass_breaking", "helicopter", "chainsaw", "siren", "car_horn", "engine",
    "train", "church_bells", "airplane", "fireworks", "hand_saw",
]

URBANSOUND8K_LABELS: List[str] = [
    "air_conditioner", "car_horn", "children_playing", "dog_bark", "drilling",
    "engine_idling", "gun_shot", "jackhammer", "siren", "street_music",
]


def load_audioset_labels(csv_path: str) -> List[str]:
    """Parse the standard AudioSet ``class_labels_indices.csv``
    (index,mid,display_name) into an index-ordered name list."""
    names = {}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            names[int(row["index"])] = row["display_name"]
    return [names[i] for i in sorted(names)]


def labels_for(dataset: str, n_classes: int, csv_path: Optional[str] = None) -> List[str]:
    """Best-available label names for a dataset config."""
    if csv_path:
        names = load_audioset_labels(csv_path)
    elif dataset == "synthetic_esc50" and n_classes == len(ESC50_LABELS):
        names = ESC50_LABELS
    elif dataset == "synthetic_us8k" and n_classes == len(URBANSOUND8K_LABELS):
        names = URBANSOUND8K_LABELS
    else:
        names = [f"class_{i}" for i in range(n_classes)]
    if len(names) != n_classes:
        raise ValueError(f"{len(names)} labels != {n_classes} classes")
    return names
