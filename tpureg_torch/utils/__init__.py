from .device import resolve_device
from .flow_io import flow_to_image, make_color_wheel, read_flo, read_gen, write_flo
from .meters import AverageMeter
from .profiling import kernel_launches, span, trace
from .seeding import derive_seed, key_seq, seed_everything

__all__ = [
    "AverageMeter",
    "derive_seed",
    "flow_to_image",
    "make_color_wheel",
    "read_flo",
    "read_gen",
    "write_flo",
    "kernel_launches",
    "span",
    "trace",
    "key_seq",
    "resolve_device",
    "seed_everything",
]
