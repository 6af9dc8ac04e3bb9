"""TRIM Task Analyst (paper §3): task description -> workloads.

Given a network description (Fig. 2 of the paper) this module emits

  * intra-layer workloads — one per layer for inference; FW/BW/WG per
    CONV/FC layer (first layer has no BW) and FW/BW per POOL layer for
    training (paper §3.1: AlexNet => 11 inference / 29 training workloads);
  * inter-layer workloads — data preprocessing (padding / upsampling /
    rot180, Eqs. 1-3) with predictable-zero fractions, and intermediate
    activation-caching liveness records (Fig. 4).

Training phase lowering (see workload.py header):
  FW : dims (N, M, C, R, S, E, F),           stride (U,V)
  BW : dims (N, C, M, R, S, Hin, Win),       stride (1,1); input = pad(up(dy))
  WG : dims (C, M, N, Pup, Qup, R, S),       stride (1,1); "filter" = up(dy)
       (dense representation: upsampling zeros stay in the operand and are
       accounted via weight_zero_frac, matching the paper's zero-skipping
       analysis — the zeros are data movement unless skipped.)

Residual adds / activations are folded into the producing layer (the paper
models CONV/POOL/FC workloads only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

from .workload import (ActivationCache, PreprocWorkload, Workload,
                       conv2d_workload, matmul_workload)


# --------------------------------------------------------------------------
# Task description (paper Fig. 2)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Conv2D:
    out_channels: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    activation: str = "ReLU"
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Pool2D:
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    mode: str = "max"
    name: str = ""


@dataclasses.dataclass(frozen=True)
class FC:
    out_features: int
    activation: str = "ReLU"
    name: str = ""


Layer = Union[Conv2D, Pool2D, FC]


@dataclasses.dataclass(frozen=True)
class TaskDescription:
    name: str
    input_shape: Tuple[int, int, int]      # (H, W, C)
    batch_size: int
    layers: Tuple[Layer, ...]
    processing_type: str = "Training"      # Training | Inference


@dataclasses.dataclass
class TaskWorkloads:
    """Task-analyst output: the schedule of intra-layer workloads (execution
    order), preprocessing workloads keyed by the intra workload they precede,
    and activation-cache liveness records."""

    intra: List[Workload]
    preproc: List[Tuple[int, PreprocWorkload]]   # (intra index, workload)
    activations: List[ActivationCache]


# --------------------------------------------------------------------------
def _conv_out(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


def _shapes_through(task: TaskDescription):
    """Per-layer (in_shape, out_shape) with shapes as (H, W, C)."""
    shapes = []
    cur = task.input_shape
    for layer in task.layers:
        h, w, c = cur
        if isinstance(layer, Conv2D):
            e = _conv_out(h, layer.kernel[0], layer.stride[0], layer.padding[0])
            f = _conv_out(w, layer.kernel[1], layer.stride[1], layer.padding[1])
            out = (e, f, layer.out_channels)
        elif isinstance(layer, Pool2D):
            e = _conv_out(h, layer.kernel[0], layer.stride[0], 0)
            f = _conv_out(w, layer.kernel[1], layer.stride[1], 0)
            out = (e, f, c)
        else:  # FC
            out = (1, 1, layer.out_features)
        shapes.append((cur, out))
        cur = out
    return shapes


def _padded_zero_frac(h, w, p_ext, q_ext):
    """Zero fraction of a (possibly padded) input extent holding an h x w
    valid region."""
    tot = p_ext * q_ext
    return max(0.0, 1.0 - min(h * w, tot) / tot)


def _upsampled_zero_frac(e, f, p_ext, q_ext):
    """Zero fraction when e x f values are scattered into p_ext x q_ext."""
    tot = p_ext * q_ext
    return max(0.0, 1.0 - min(e * f, tot) / tot)


def _fw_workload(i, layer, in_shape, out_shape, n):
    h, w, c = in_shape
    e, f, m = out_shape
    lname = layer.name or f"L{i+1}"
    if isinstance(layer, Conv2D):
        kr, ks = layer.kernel
        p_ext = (e - 1) * layer.stride[0] + kr
        q_ext = (f - 1) * layer.stride[1] + ks
        return conv2d_workload(
            batch=n, in_ch=c, out_ch=m, out_h=e, out_w=f, kr=kr, ks=ks,
            stride=layer.stride, name=f"{lname}.FW", phase="FW",
            input_zero_frac=_padded_zero_frac(h, w, p_ext, q_ext))
    if isinstance(layer, Pool2D):
        kr, ks = layer.kernel
        return Workload(dims=(n, 1, c, kr, ks, e, f), stride=layer.stride,
                        kind=f"pool_{layer.mode}", depthwise=True,
                        name=f"{lname}.FW", layer=lname, phase="FW")
    return matmul_workload(rows=n, cols=m, inner=h * w * c,
                           name=f"{lname}.FW", phase="FW")


def _bw_workload(i, layer, in_shape, out_shape, n):
    h, w, c = in_shape
    e, f, m = out_shape
    lname = layer.name or f"L{i+1}"
    if isinstance(layer, Conv2D):
        kr, ks = layer.kernel
        p_ext = h + kr - 1  # pad(up(dy)) extent producing dx of size h x w
        q_ext = w + ks - 1
        return Workload(dims=(n, c, m, kr, ks, h, w), stride=(1, 1),
                        name=f"{lname}.BW", layer=lname, phase="BW",
                        input_zero_frac=_upsampled_zero_frac(e, f, p_ext, q_ext))
    if isinstance(layer, Pool2D):
        kr, ks = layer.kernel
        return Workload(dims=(n, 1, c, kr, ks, e, f), stride=layer.stride,
                        kind=f"pool_{layer.mode}", depthwise=True,
                        name=f"{lname}.BW", layer=lname, phase="BW")
    return matmul_workload(rows=n, cols=h * w * c, inner=m,
                           name=f"{lname}.BW", phase="BW")


def _wg_workload(i, layer, in_shape, out_shape, n):
    h, w, c = in_shape
    e, f, m = out_shape
    lname = layer.name or f"L{i+1}"
    if isinstance(layer, Conv2D):
        kr, ks = layer.kernel
        p_up = (e - 1) * layer.stride[0] + 1   # upsampled dy extent
        q_up = (f - 1) * layer.stride[1] + 1
        p_in = kr + p_up - 1                   # same padded x as FW
        q_in = ks + q_up - 1
        return Workload(dims=(c, m, n, p_up, q_up, kr, ks), stride=(1, 1),
                        name=f"{lname}.WG", layer=lname, phase="WG",
                        input_zero_frac=_padded_zero_frac(h, w, p_in, q_in),
                        weight_zero_frac=_upsampled_zero_frac(e, f, p_up, q_up))
    # FC: dW[in, out] = X^T dY
    return matmul_workload(rows=h * w * c, cols=m, inner=n,
                           name=f"{lname}.WG", phase="WG")


def analyze(task: TaskDescription) -> TaskWorkloads:
    """Paper Algorithm 1 line 3."""
    n = task.batch_size
    shapes = _shapes_through(task)
    training = task.processing_type.lower() == "training"
    intra: List[Workload] = []
    preproc: List[Tuple[int, PreprocWorkload]] = []
    fw_index: List[int] = []

    # ---- forward pass --------------------------------------------------
    for i, layer in enumerate(task.layers):
        in_shape, out_shape = shapes[i]
        wl = _fw_workload(i, layer, in_shape, out_shape, n)
        if isinstance(layer, Conv2D) and layer.padding != (0, 0):
            preproc.append((len(intra), PreprocWorkload(
                op="padding", out_words=math.prod(wl.input_shape),
                zero_frac=wl.input_zero_frac, name=wl.name, phase="FW")))
        fw_index.append(len(intra))
        intra.append(wl)

    activations: List[ActivationCache] = []
    if not training:
        return TaskWorkloads(intra=intra, preproc=preproc,
                             activations=activations)

    # ---- backward pass (reverse layer order; paper Fig. 4) -------------
    wg_index = {}
    for i in reversed(range(len(task.layers))):
        layer = task.layers[i]
        in_shape, out_shape = shapes[i]
        has_bw = i > 0                       # first layer: no BW (paper §3.1)
        has_wg = not isinstance(layer, Pool2D)  # POOL: no WG (paper §3.1)
        if has_bw:
            wl = _bw_workload(i, layer, in_shape, out_shape, n)
            if isinstance(layer, Conv2D):
                preproc.append((len(intra), PreprocWorkload(
                    op="upsampling", out_words=math.prod(wl.input_shape),
                    zero_frac=wl.input_zero_frac, name=wl.name, phase="BW")))
                preproc.append((len(intra), PreprocWorkload(
                    op="rot180", out_words=math.prod(wl.weight_shape),
                    name=wl.name, phase="BW")))
            intra.append(wl)
        if has_wg:
            wl = _wg_workload(i, layer, in_shape, out_shape, n)
            if isinstance(layer, Conv2D):
                preproc.append((len(intra), PreprocWorkload(
                    op="upsampling", out_words=math.prod(wl.weight_shape),
                    zero_frac=wl.weight_zero_frac, name=wl.name, phase="WG")))
            wg_index[i] = len(intra)
            intra.append(wl)

    # ---- activation caching liveness (paper §3.3, Fig. 4) --------------
    for i, layer in enumerate(task.layers):
        if isinstance(layer, Pool2D):
            continue
        in_shape, _ = shapes[i]
        h, w, c = in_shape
        freed = wg_index.get(i)
        if freed is None:
            continue
        activations.append(ActivationCache(
            words=n * h * w * c, created=fw_index[i], freed=freed + 1,
            name=f"x{i+1}"))
    return TaskWorkloads(intra=intra, preproc=preproc,
                         activations=activations)


# --------------------------------------------------------------------------
# Benchmark networks used in the paper (§7-8)
# --------------------------------------------------------------------------
def alexnet_imagenet(batch_size=64, processing="Training") -> TaskDescription:
    """AlexNet [30] on 224x224x3 (ImageNet)."""
    return TaskDescription(
        name="AlexNet-IM", input_shape=(224, 224, 3), batch_size=batch_size,
        processing_type=processing, layers=(
            Conv2D(64, (11, 11), (4, 4), (2, 2), name="conv1"),
            Pool2D((3, 3), (2, 2), name="pool1"),
            Conv2D(192, (5, 5), (1, 1), (2, 2), name="conv2"),
            Pool2D((3, 3), (2, 2), name="pool2"),
            Conv2D(384, (3, 3), (1, 1), (1, 1), name="conv3"),
            Conv2D(256, (3, 3), (1, 1), (1, 1), name="conv4"),
            Conv2D(256, (3, 3), (1, 1), (1, 1), name="conv5"),
            Pool2D((3, 3), (2, 2), name="pool3"),
            FC(4096, name="fc6"), FC(4096, name="fc7"),
            FC(1000, activation="Sigmoid", name="fc8"),
        ))


def alexnet_cifar(batch_size=64, processing="Training") -> TaskDescription:
    """Modified AlexNet for CIFAR-10 [31] (icpm/pytorch-cifar10 variant)."""
    return TaskDescription(
        name="AlexNet-Cifar", input_shape=(32, 32, 3), batch_size=batch_size,
        processing_type=processing, layers=(
            Conv2D(64, (3, 3), (2, 2), (1, 1), name="conv1"),
            Pool2D((2, 2), (2, 2), name="pool1"),
            Conv2D(192, (3, 3), (1, 1), (1, 1), name="conv2"),
            Pool2D((2, 2), (2, 2), name="pool2"),
            Conv2D(384, (3, 3), (1, 1), (1, 1), name="conv3"),
            Conv2D(256, (3, 3), (1, 1), (1, 1), name="conv4"),
            Conv2D(256, (3, 3), (1, 1), (1, 1), name="conv5"),
            Pool2D((2, 2), (2, 2), name="pool3"),
            FC(4096, name="fc6"), FC(4096, name="fc7"),
            FC(10, activation="Sigmoid", name="fc8"),
        ))


def vgg11(batch_size=64, input_hw=224, num_classes=1000,
          processing="Training") -> TaskDescription:
    cfg = [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"]
    layers: List[Layer] = []
    ci = 1
    for v in cfg:
        if v == "M":
            layers.append(Pool2D((2, 2), (2, 2), name=f"pool{ci}"))
        else:
            layers.append(Conv2D(v, (3, 3), (1, 1), (1, 1), name=f"conv{ci}"))
            ci += 1
    head = 4096 if input_hw >= 64 else 512
    layers += [FC(head, name="fc1"), FC(head, name="fc2"),
               FC(num_classes, activation="Sigmoid", name="fc3")]
    return TaskDescription(name=f"VGG11-{input_hw}",
                           input_shape=(input_hw, input_hw, 3),
                           batch_size=batch_size, processing_type=processing,
                           layers=tuple(layers))


def _resnet_basic(layers: List[Layer], in_ch, out_ch, stride, tag):
    layers.append(Conv2D(out_ch, (3, 3), (stride, stride), (1, 1),
                         name=f"{tag}a"))
    layers.append(Conv2D(out_ch, (3, 3), (1, 1), (1, 1), name=f"{tag}b"))


def resnet20_cifar(batch_size=64, processing="Training") -> TaskDescription:
    """ResNet-20 [33] for CIFAR-10: 3 stages x 3 basic blocks."""
    layers: List[Layer] = [Conv2D(16, (3, 3), (1, 1), (1, 1), name="conv0")]
    ch, in_ch = [16, 32, 64], 16
    for si, c in enumerate(ch):
        for bi in range(3):
            stride = 2 if (si > 0 and bi == 0) else 1
            _resnet_basic(layers, in_ch, c, stride, f"s{si}b{bi}")
            in_ch = c
    layers.append(Pool2D((8, 8), (8, 8), mode="avg", name="gap"))
    layers.append(FC(10, activation="Sigmoid", name="fc"))
    return TaskDescription(name="ResNet20-Cifar", input_shape=(32, 32, 3),
                           batch_size=batch_size, processing_type=processing,
                           layers=tuple(layers))


def resnet18_imagenet(batch_size=64, processing="Training") -> TaskDescription:
    layers: List[Layer] = [
        Conv2D(64, (7, 7), (2, 2), (3, 3), name="conv0"),
        Pool2D((3, 3), (2, 2), name="pool0")]
    ch, in_ch = [64, 128, 256, 512], 64
    for si, c in enumerate(ch):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            _resnet_basic(layers, in_ch, c, stride, f"s{si}b{bi}")
            in_ch = c
    layers.append(Pool2D((7, 7), (7, 7), mode="avg", name="gap"))
    layers.append(FC(1000, activation="Sigmoid", name="fc"))
    return TaskDescription(name="ResNet18-IM", input_shape=(224, 224, 3),
                           batch_size=batch_size, processing_type=processing,
                           layers=tuple(layers))


NETWORKS = {
    "alexnet-im": alexnet_imagenet,
    "alexnet-cifar": alexnet_cifar,
    "vgg11-im": lambda **kw: vgg11(input_hw=224, **kw),
    "vgg11-cifar": lambda **kw: vgg11(input_hw=32, num_classes=10, **kw),
    "resnet20-cifar": resnet20_cifar,
    "resnet18-im": resnet18_imagenet,
}
