"""Category tables of the video instance datasets (names in official dataset
id order): contiguous training ids are index-in-list, official annotation ids
are 1-based.

Counterpart: ``dvis_plus_tpu/data/datasets/categories.py``, without the
COCO -> video-dataset id maps, which only joint training with COCO
pseudo-videos reads.
"""
from __future__ import annotations

YTVIS_2019_CLASSES = [
    "person", "giant_panda", "lizard", "parrot", "skateboard", "sedan", "ape",
    "dog", "snake", "monkey", "hand", "rabbit", "duck", "cat", "cow", "fish",
    "train", "horse", "turtle", "bear", "motorbike", "giraffe", "leopard",
    "fox", "deer", "owl", "surfboard", "airplane", "truck", "zebra", "tiger",
    "elephant", "snowboard", "boat", "shark", "mouse", "frog", "eagle",
    "earless_seal", "tennis_racket",
]

YTVIS_2021_CLASSES = [
    "airplane", "bear", "bird", "boat", "car", "cat", "cow", "deer", "dog",
    "duck", "earless_seal", "elephant", "fish", "flying_disc", "fox", "frog",
    "giant_panda", "giraffe", "horse", "leopard", "lizard", "monkey",
    "motorbike", "mouse", "parrot", "person", "rabbit", "shark", "skateboard",
    "snake", "snowboard", "squirrel", "surfboard", "tennis_racket", "tiger",
    "train", "truck", "turtle", "whale", "zebra",
]

OVIS_CLASSES = [
    "Person", "Bird", "Cat", "Dog", "Horse", "Sheep", "Cow", "Elephant",
    "Bear", "Zebra", "Giraffe", "Poultry", "Giant_panda", "Lizard", "Parrot",
    "Monkey", "Rabbit", "Tiger", "Fish", "Turtle", "Bicycle", "Motorcycle",
    "Airplane", "Boat", "Vehical",
]

# BDD100K seg-track / MOTS (1-based official ids)
BDD_TRACK_CLASSES = [
    "pedestrian", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]


def thing_dataset_id_to_contiguous_id(classes) -> dict:
    """Official 1-based category id -> contiguous 0-based training id."""
    return {i + 1: i for i in range(len(classes))}
