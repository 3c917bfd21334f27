"""Category tables of the video instance datasets (names in official dataset
id order): contiguous training ids are index-in-list, official annotation ids
are 1-based.

Counterpart: ``dvis_plus_tpu/data/datasets/categories.py``, with the
COCO -> video-dataset id maps that the COCO pseudo-video splits
(``data/datasets/coco.py``) load through.
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


# COCO official (1-based) category ids -> video-dataset official (1-based)
# category ids, for joint COCO pseudo-video training
COCO_TO_YTVIS_2019 = {
    1: 1, 2: 21, 3: 6, 4: 21, 5: 28, 7: 17, 8: 29, 9: 34, 17: 14, 18: 8,
    19: 18, 21: 15, 22: 32, 23: 20, 24: 30, 25: 22, 35: 33, 36: 33, 41: 5,
    42: 27, 43: 40,
}
COCO_TO_YTVIS_2021 = {
    1: 26, 2: 23, 3: 5, 4: 23, 5: 1, 7: 36, 8: 37, 9: 4, 16: 3, 17: 6,
    18: 9, 19: 19, 21: 7, 22: 12, 23: 2, 24: 40, 25: 18, 34: 14, 35: 31,
    36: 31, 41: 29, 42: 33, 43: 34,
}
COCO_TO_OVIS = {
    1: 1, 2: 21, 3: 25, 4: 22, 5: 23, 6: 25, 8: 25, 9: 24, 17: 3, 18: 4,
    19: 5, 20: 6, 21: 7, 22: 8, 23: 9, 24: 10, 25: 11,
}
