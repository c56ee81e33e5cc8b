"""BNN inference workloads — paper Sec. V-B.

The four evaluated BNNs (batch size 1, LQ-Nets binarized): VGG-small
(CIFAR-10) and ResNet18 / MobileNet_V2 / ShuffleNet_V2 (ImageNet 224).

A layer is reduced to the quantities the XPC mapping needs (Sec. IV-B):
  S = flattened vector size = k*k*C_in/groups   (the contraction length)
  V = number of VDPs = C_out * H_out * W_out    (outputs)
plus input/weight bit volumes for the IO model.  The paper's maximum
S = 4608 (= 3*3*512) appears in VGG-small/ResNet18 as expected
(Sec. IV-C), property-checked in tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LayerSpec:
    name: str
    c_in: int
    c_out: int
    k: int
    stride: int
    h_in: int
    w_in: int
    groups: int = 1
    pad: int | None = None  # default: 'same'-ish k//2
    # rows streamed through the SAME weight-stationary layer back to
    # back (serving replay: a decode batch of B requests).  Extra rows
    # add VDP outputs — more waves over the XPE pool, sharing the
    # layer's pipeline fill and its programmed MRR weight banks — so
    # batching has a modeled hardware cost curve instead of B× the
    # batch-1 latency.  Weight volume (and TUNE work) does not scale.
    batch: int = 1

    def with_batch(self, n: int) -> "LayerSpec":
        return dataclasses.replace(self, batch=max(int(n), 1))

    @property
    def h_out(self) -> int:
        p = self.k // 2 if self.pad is None else self.pad
        return (self.h_in + 2 * p - self.k) // self.stride + 1

    @property
    def w_out(self) -> int:
        p = self.k // 2 if self.pad is None else self.pad
        return (self.w_in + 2 * p - self.k) // self.stride + 1

    @property
    def s(self) -> int:
        """Flattened vector size per output (contraction length)."""
        return self.k * self.k * self.c_in // self.groups

    @property
    def v(self) -> int:
        """Number of vector-dot-products (outputs, x batch rows)."""
        return self.batch * self.c_out * self.h_out * self.w_out

    @property
    def input_bits(self) -> int:
        return self.batch * self.c_in * self.h_in * self.w_in

    @property
    def weight_bits(self) -> int:
        return self.c_out * self.s

    @property
    def macs(self) -> int:
        return self.v * self.s


def fc(name: str, c_in: int, c_out: int) -> LayerSpec:
    return LayerSpec(name, c_in, c_out, k=1, stride=1, h_in=1, w_in=1, pad=0)


def _conv(name, c_in, c_out, k, s, r, groups=1) -> LayerSpec:
    return LayerSpec(name, c_in, c_out, k, s, r, r, groups)


def vgg_small() -> list[LayerSpec]:
    """VGG-small (LQ-Nets [9], CIFAR-10 32x32)."""
    ls = [
        _conv("conv1", 3, 128, 3, 1, 32),
        _conv("conv2", 128, 128, 3, 1, 32),
        _conv("conv3", 128, 256, 3, 1, 16),
        _conv("conv4", 256, 256, 3, 1, 16),
        _conv("conv5", 256, 512, 3, 1, 8),
        _conv("conv6", 512, 512, 3, 1, 8),
        fc("fc1", 512 * 4 * 4, 1024),
        fc("fc2", 1024, 10),
    ]
    return ls


def resnet18() -> list[LayerSpec]:
    """ResNet18 [27] (ImageNet 224)."""
    ls = [_conv("conv1", 3, 64, 7, 2, 224)]
    r = 56
    cfg = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
    for i, (cin, cout, s1) in enumerate(cfg):
        # block 1 (possibly strided, with 1x1 downsample)
        ls.append(_conv(f"l{i}b0c1", cin, cout, 3, s1, r))
        r = r // s1
        ls.append(_conv(f"l{i}b0c2", cout, cout, 3, 1, r))
        if s1 != 1 or cin != cout:
            ls.append(LayerSpec(f"l{i}b0ds", cin, cout, 1, s1, r * s1, r * s1, pad=0))
        # block 2
        ls.append(_conv(f"l{i}b1c1", cout, cout, 3, 1, r))
        ls.append(_conv(f"l{i}b1c2", cout, cout, 3, 1, r))
    ls.append(fc("fc", 512, 1000))
    return ls


def mobilenet_v2() -> list[LayerSpec]:
    """MobileNet_V2 [28] (ImageNet 224), inverted residual t,c,n,s table."""
    ls = [_conv("stem", 3, 32, 3, 2, 224)]
    r, cin = 112, 32
    table = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for bi, (t, c, n, s) in enumerate(table):
        for j in range(n):
            stride = s if j == 0 else 1
            hid = cin * t
            if t != 1:
                ls.append(LayerSpec(f"b{bi}_{j}expand", cin, hid, 1, 1, r, r, pad=0))
            ls.append(_conv(f"b{bi}_{j}dw", hid, hid, 3, stride, r, groups=hid))
            r = r // stride
            ls.append(LayerSpec(f"b{bi}_{j}proj", hid, c, 1, 1, r, r, pad=0))
            cin = c
    ls.append(LayerSpec("head", 320, 1280, 1, 1, 7, 7, pad=0))
    ls.append(fc("fc", 1280, 1000))
    return ls


def shufflenet_v2() -> list[LayerSpec]:
    """ShuffleNet_V2 1x [29] (ImageNet 224)."""
    ls = [_conv("stem", 3, 24, 3, 2, 224)]
    r, cin = 56, 24  # after 3x3/2 conv + 3x3/2 maxpool
    stages = [(116, 4), (232, 8), (464, 4)]
    for si, (c, n) in enumerate(stages):
        half = c // 2
        for j in range(n):
            if j == 0:
                # spatial-down unit: both branches, stride 2
                ls.append(_conv(f"s{si}_0dwA", cin, cin, 3, 2, r, groups=cin))
                ls.append(LayerSpec(f"s{si}_0pwA", cin, half, 1, 1, r // 2, r // 2, pad=0))
                ls.append(LayerSpec(f"s{si}_0pw1", cin, half, 1, 1, r, r, pad=0))
                ls.append(_conv(f"s{si}_0dwB", half, half, 3, 2, r, groups=half))
                ls.append(LayerSpec(f"s{si}_0pw2", half, half, 1, 1, r // 2, r // 2, pad=0))
                r = r // 2
            else:
                ls.append(LayerSpec(f"s{si}_{j}pw1", half, half, 1, 1, r, r, pad=0))
                ls.append(_conv(f"s{si}_{j}dw", half, half, 3, 1, r, groups=half))
                ls.append(LayerSpec(f"s{si}_{j}pw2", half, half, 1, 1, r, r, pad=0))
            cin = c
    ls.append(LayerSpec("conv5", 464, 1024, 1, 1, 7, 7, pad=0))
    ls.append(fc("fc", 1024, 1000))
    return ls


WORKLOADS = {
    "vgg_small": vgg_small,
    "resnet18": resnet18,
    "mobilenet_v2": mobilenet_v2,
    "shufflenet_v2": shufflenet_v2,
}


def max_vector_size() -> int:
    """Paper Sec. IV-C: max S across modern CNNs is 4608."""
    return max(l.s for f in WORKLOADS.values() for l in f())
