from .ofe import (
    Affloss,
    DEFloss3D,
    OFEloss,
    charbonnier,
    correlation_loss,
    correlation_loss_3d,
    photometric_loss,
    photometric_loss_3d,
    smoothness_loss,
    smoothness_loss_3d,
)

__all__ = ["Affloss", "DEFloss3D", "OFEloss", "charbonnier", "correlation_loss",
           "correlation_loss_3d", "photometric_loss", "photometric_loss_3d",
           "smoothness_loss", "smoothness_loss_3d"]
