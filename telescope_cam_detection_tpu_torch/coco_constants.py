"""COCO class data and Stage-2 routing tables.

Public-dataset facts plus the routing/filter policy the reference encodes in
``src/coco_constants.py:23-44`` (wildlife filter + Stage-2 category routing).
"""

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)

NUM_COCO_CLASSES = len(COCO_CLASSES)

# Wildlife-relevant COCO classes (Mojave policy, reference coco_constants.py:23-29)
WILDLIFE_CLASSES = {
    0: "person",
    14: "bird",
    15: "cat",   # bobcat / wild cats
    16: "dog",   # coyote / fox
    21: "bear",  # rare
}

# Stage-2 routing: COCO class id -> classifier category
CLASS_ID_TO_CATEGORY = {
    14: "bird",
    15: "mammal",
    16: "mammal",
    21: "mammal",
}

MAMMAL_CLASS_IDS = (15, 16, 21)

# Legacy perf anchors kept for parity with reference stats surfaces
GROUNDINGDINO_BASELINE_MS = 560
YOLOX_TARGET_MS = 15


def class_name(class_id: int) -> str:
    if 0 <= class_id < NUM_COCO_CLASSES:
        return COCO_CLASSES[class_id]
    return f"class_{class_id}"
