from .export import (
    PLATFORMS,
    compare_outputs,
    deterministic_cudnn,
    export_registration,
    load_artifact,
    save_artifact,
)

__all__ = ["PLATFORMS", "compare_outputs", "deterministic_cudnn",
           "export_registration", "load_artifact", "save_artifact"]
