"""The paper's own CNN configurations (LeNet / VGG9 / VGG16 / AlexNet).

These are not ModelConfig LMs: they are layer-IR builders (see
``models.vision``), exposed here so ``--arch lenet`` etc. resolve from the
same place as the LM architectures.
"""

from repro_torch.models.vision import (VISION_MODELS, alexnet_ir, lenet_ir,
                                       vgg9_ir, vgg16_ir)

__all__ = ["VISION_MODELS", "lenet_ir", "vgg9_ir", "vgg16_ir", "alexnet_ir"]
