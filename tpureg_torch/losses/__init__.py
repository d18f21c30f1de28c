from .ofe import (
    OFEloss,
    charbonnier,
    correlation_loss,
    photometric_loss,
    smoothness_loss,
)

__all__ = ["OFEloss", "charbonnier", "correlation_loss", "photometric_loss",
           "smoothness_loss"]
