"""The imaging pipelines on the port: registry, float oracle and metrics.

``fit_recon_head`` (training the deconv head through autograd) is not
ported yet.
"""

from repro_torch.imaging.metrics import psnr, ssim
from repro_torch.imaging.pipelines import (PIPELINES, ImagingPipeline,
                                           gray_target,
                                           recon_head_identity_params)
from repro_torch.imaging.reference import apply_float

__all__ = ["PIPELINES", "ImagingPipeline", "apply_float", "gray_target",
           "psnr", "recon_head_identity_params", "ssim"]
