"""Native ``.caffemodel`` dump reader (no caffe or protobuf dependency),
the port's copy of ``tpureg/compat/caffe_reader.py`` (numpy only).

The reference's caffe-weight parsers (flownet2/utils/param_utils.py:5-254)
consume ``weights[name]`` / ``biases[name]`` numpy dicts extracted from a
caffe ``NetParameter`` protobuf. This module parses that on-disk container
directly with a minimal protobuf *wire-format* walker; the caffemodel schema
is stable (caffe.proto): ``NetParameter.layer = 100`` (new) / ``layers = 2``
(V1), ``LayerParameter{name=1, blobs=7}`` / ``V1LayerParameter{name=4,
blobs=6}``, ``BlobProto{num=1, channels=2, height=3, width=4, data=5
(packed float), shape=7 (BlobShape{dim=1 packed int64}), double_data=8}``.

The per-net layer orderings and stem-conv BGR channel flips from
param_utils.py are reproduced in :data:`CAFFE_NETS`, feeding
:func:`tpureg_torch.compat.caffe_import.assign_layer_ordered`.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "read_caffemodel",
    "caffe_weights_biases",
    "caffe_layers",
    "CAFFE_NETS",
]


# ---------------------------------------------------------------------------
# protobuf wire-format primitives

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's wire bytes.

    value: int for varint/fixed32/fixed64, bytes for length-delimited.
    """
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            v = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            v = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def _packed_ints(buf: bytes) -> List[int]:
    out, i = [], 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def _parse_blob(buf: bytes) -> Optional[np.ndarray]:
    """BlobProto → float numpy array with its recorded shape (or None)."""
    shape: List[int] = []
    legacy = {}
    data = np.zeros(0, np.float32)
    unpacked: List[float] = []
    for field, wt, v in _fields(buf):
        if field == 5:  # data: packed float (or repeated fixed32)
            if wt == 2:
                data = np.frombuffer(v, dtype="<f4")
            else:
                unpacked.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif field == 8:  # double_data
            if wt == 2:
                data = np.frombuffer(v, dtype="<f8").astype(np.float32)
        elif field == 7 and wt == 2:  # shape: BlobShape
            for f2, wt2, v2 in _fields(v):
                if f2 == 1:
                    shape.extend(_packed_ints(v2) if wt2 == 2 else [v2])
        elif field in (1, 2, 3, 4) and wt == 0:  # legacy num/channels/h/w
            legacy[field] = v
    if unpacked:
        data = np.asarray(unpacked, np.float32)
    if data.size == 0:
        return None
    if not shape and legacy:
        shape = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
        # trim leading singleton dims the legacy format pads with
        while len(shape) > 1 and shape[0] == 1 and int(
                np.prod(shape[1:])) == data.size:
            shape = shape[1:]
    if shape and int(np.prod(shape)) == data.size:
        return data.reshape(shape)
    return data


def _parse_layer(buf: bytes, v1: bool) -> Tuple[str, List[np.ndarray]]:
    name_field = 4 if v1 else 1
    blobs_field = 6 if v1 else 7
    name, blobs = "", []
    for field, wt, v in _fields(buf):
        if field == name_field and wt == 2:
            name = v.decode("utf-8", "replace")
        elif field == blobs_field and wt == 2:
            blob = _parse_blob(v)
            if blob is not None:
                blobs.append(blob)
    return name, blobs


def read_caffemodel(path_or_bytes) -> Dict[str, List[np.ndarray]]:
    """Parse a ``.caffemodel`` NetParameter → {layer_name: [blob, ...]}.

    Accepts a filesystem path or raw bytes. Handles both the modern
    ``layer`` (field 100) and deprecated V1 ``layers`` (field 2) formats;
    layers without blobs (ReLU, Eltwise, ...) are skipped.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    out: Dict[str, List[np.ndarray]] = {}
    for field, wt, v in _fields(buf):
        if wt == 2 and field in (100, 2):
            name, blobs = _parse_layer(v, v1=(field == 2))
            if name and blobs:
                out[name] = blobs
    return out


def caffe_weights_biases(
    path_or_bytes,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """The reference parsers' exact input contract: two dicts keyed by
    caffe layer name — blob 0 as the (O, I, kh, kw) weight, blob 1 as the
    bias (param_utils.py ``weights[key]`` / ``biases[key]``)."""
    blobs = read_caffemodel(path_or_bytes)
    weights = {k: v[0] for k, v in blobs.items()}
    biases = {k: v[1] if len(v) > 1 else np.zeros(0, np.float32)
              for k, v in blobs.items()}
    return weights, biases


# ---------------------------------------------------------------------------
# reference layer orderings (param_utils.py:5-254)

def _prefixed(keys, prefix, double_prefix_upsample=False):
    out = []
    for k in keys:
        if double_prefix_upsample and "upsample" in k:
            out.append(prefix + prefix + k)  # param_utils.py:80-83 quirk
        else:
            out.append(prefix + k)
    return out


_C_KEYS = [
    "conv1", "conv2", "conv3", "conv_redir", "conv3_1", "conv4", "conv4_1",
    "conv5", "conv5_1", "conv6", "conv6_1",
    "deconv5", "deconv4", "deconv3", "deconv2",
    "Convolution1", "Convolution2", "Convolution3", "Convolution4",
    "Convolution5",
    "upsample_flow6to5", "upsample_flow5to4", "upsample_flow4to3",
    "upsample_flow3to2",
]
_S_KEYS = [
    "conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1", "conv5",
    "conv5_1", "conv6", "conv6_1",
    "deconv5", "deconv4", "deconv3", "deconv2",
    "predict_conv6", "predict_conv5", "predict_conv4", "predict_conv3",
    "predict_conv2",
    "upsample_flow6to5", "upsample_flow5to4", "upsample_flow4to3",
    "upsample_flow3to2",
]
_SONLY_KEYS = [
    "conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1", "conv5",
    "conv5_1", "conv6", "conv6_1",
    "deconv5", "deconv4", "deconv3", "deconv2",
    "Convolution1", "Convolution2", "Convolution3", "Convolution4",
    "Convolution5",
    "upsample_flow6to5", "upsample_flow5to4", "upsample_flow4to3",
    "upsample_flow3to2",
]
_SD_KEYS = [
    "conv0", "conv1", "conv1_1", "conv2", "conv2_1", "conv3", "conv3_1",
    "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1",
    "deconv5", "deconv4", "deconv3", "deconv2",
    "interconv5", "interconv4", "interconv3", "interconv2",
    "Convolution1", "Convolution2", "Convolution3", "Convolution4",
    "Convolution5",
    "upsample_flow6to5", "upsample_flow5to4", "upsample_flow4to3",
    "upsample_flow3to2",
]
_FUSION_KEYS = [
    "conv0", "conv1", "conv1_1", "conv2", "conv2_1",
    "deconv1", "deconv0",
    "interconv1", "interconv0",
    "_Convolution5", "_Convolution6", "_Convolution7",
    "upsample_flow2to1", "upsample_flow1to0",
]

# net → (ordered caffe keys, default param_prefix, double-prefix-upsample?,
#        stem BGR flip slices). Flip slices are (start, stop) input-channel
# ranges reversed on the FIRST conv (param_utils.py conv0/conv1 handling):
# flownetc flips all channels; flownets flips the three RGB triplets of its
# 12-ch caffe stem; sonly/sd flip two triplets; fusion flips one.
CAFFE_NETS = {
    "flownetc": (_C_KEYS, "", False, "all"),
    "flownets": (_S_KEYS, "net2_", True, [(0, 3), (3, 6), (6, 9)]),
    "flownetsonly": (_SONLY_KEYS, "", True, [(0, 3), (3, 6)]),
    "flownetsd": (_SD_KEYS, "netsd_", False, [(0, 3), (3, 6)]),
    "flownetfusion": (_FUSION_KEYS, "fuse_", False, [(0, 3)]),
}


def _flip_stem(weight: np.ndarray, spec) -> np.ndarray:
    w = weight.copy()
    if spec == "all":
        return w[:, ::-1].copy()
    for lo, hi in spec:
        if hi <= w.shape[1]:
            w[:, lo:hi] = w[:, lo:hi][:, ::-1]
    return w


def caffe_layers(
    path_or_bytes,
    net: str,
    param_prefix: Optional[str] = None,
) -> List[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Ordered (weight, bias) pairs for ``net`` from a caffemodel dump,
    with the reference's stem BGR→RGB channel flips applied — ready for
    :func:`caffe_import.assign_layer_ordered`.
    """
    if net not in CAFFE_NETS:
        raise ValueError(f"unknown caffe net {net!r}; one of "
                         f"{sorted(CAFFE_NETS)}")
    keys, default_prefix, double_up, flip_spec = CAFFE_NETS[net]
    prefix = default_prefix if param_prefix is None else param_prefix
    keys = _prefixed(keys, prefix, double_up)
    weights, biases = caffe_weights_biases(path_or_bytes)
    missing = [k for k in keys if k not in weights]
    if missing:
        raise KeyError(f"caffemodel missing layers for {net}: {missing[:5]}"
                       + ("..." if len(missing) > 5 else ""))
    out = []
    for i, k in enumerate(keys):
        w = np.asarray(weights[k], np.float32)
        b = np.asarray(biases[k], np.float32)
        if i == 0:
            w = _flip_stem(w, flip_spec)
        out.append((w, b if b.size else None))
    return out
