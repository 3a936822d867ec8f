"""PyTorch/CUDA port of ``telescope_cam_detection_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
the name of its counterpart there, and ``tests/test_torch_*.py`` hold each
one against it on the CPU. This package imports torch and numpy only, never
JAX or the JAX package.

Stage 1 is the YOLOX detector program (``runtime/program.py``):
uint8 BGR frames -> bilinear resize -> YOLOX forward (cuDNN convolutions) ->
decode -> batched class-aware NMS, whose greedy suppression runs in the
hand-written CUDA kernel ``csrc/nms_suppress.cu`` -> scale back -> runtime
filters -> (B, max_det, 7) rows.

Stage 2 is species classification (``pipeline/two_stage.py`` over
``pipeline/species.py``): eligible detections are cropped on the device
(``ops/crops.py``), classified by EVA02 (``models/eva02.py``), whose
attention runs in the hand-written CUDA kernel ``csrc/attention.cu``, and
annotated with taxonomy labels and time-of-day re-ranking.

RT-DETR (``runtime/program.py`` with ``detector_type="rtdetr"``, over
``models/rtdetr.py``) is the NMS-free detector: ResNet-vd and the hybrid
encoder (cuDNN convolutions), then a deformable-attention decoder whose
multi-scale sampling runs in the hand-written CUDA kernel ``csrc/deform.cu``.

Entry points take ``device``, default ``"cuda"``; they raise when CUDA is
missing unless the caller passes ``device="cpu"``, which runs each kernel's
plain PyTorch version instead.
"""

__version__ = "0.1.0"
