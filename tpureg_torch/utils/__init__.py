from .device import resolve_device
from .meters import AverageMeter
from .seeding import derive_seed, seed_everything

__all__ = ["AverageMeter", "derive_seed", "resolve_device", "seed_everything"]
