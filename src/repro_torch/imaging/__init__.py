"""The imaging pipelines on the port: registry, float oracle, metrics, and
``fit_recon_head``, which trains ``compress_recon_deconv``'s learned head
through the float oracle with autograd.
"""

from repro_torch.imaging.metrics import psnr, ssim
from repro_torch.imaging.pipelines import (PIPELINES, ImagingPipeline,
                                           fit_recon_head, gray_target,
                                           recon_head_identity_params)
from repro_torch.imaging.reference import apply_float

__all__ = ["PIPELINES", "ImagingPipeline", "apply_float", "fit_recon_head",
           "gray_target", "psnr", "recon_head_identity_params", "ssim"]
