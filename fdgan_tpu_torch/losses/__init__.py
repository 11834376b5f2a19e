"""Training objectives: adversarial BCE, pixel, perceptual and SSIM terms."""
