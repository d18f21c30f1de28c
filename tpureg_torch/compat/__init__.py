from .caffe_import import assign_layer_ordered, bgr_to_rgb_first_conv, conv_walk
from .caffe_reader import (
    CAFFE_NETS,
    caffe_layers,
    caffe_weights_biases,
    read_caffemodel,
)
from .from_jax import (
    load_adam_state_from_jax,
    state_dict_from_jax,
    state_dict_from_jax_3d,
    state_dict_from_jax_raft,
)
from .torch_import import (
    collapse_rgb_input,
    collapse_rgb_pair_input,
    import_torch_state_dict,
    load_torch_checkpoint,
)

__all__ = ["CAFFE_NETS", "assign_layer_ordered", "bgr_to_rgb_first_conv",
           "caffe_layers", "caffe_weights_biases", "conv_walk", "read_caffemodel",
           "collapse_rgb_input", "collapse_rgb_pair_input",
           "import_torch_state_dict", "load_adam_state_from_jax",
           "load_torch_checkpoint", "state_dict_from_jax",
           "state_dict_from_jax_3d", "state_dict_from_jax_raft"]
