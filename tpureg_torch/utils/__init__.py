from .device import resolve_device
from .meters import AverageMeter

__all__ = ["AverageMeter", "resolve_device"]
