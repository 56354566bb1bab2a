"""Workload definitions: the paper's Table II CNN suite, plus extraction of
VMM workloads from the framework's LM architectures (paper §VI notes the
techniques apply to RNN/LSTM-class models; our LM-serving estimates realize
that claim — see ``lm_workload``).

A copy of ``repro.core.workloads`` (which imports no JAX) on the port's own
core modules; its results equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Layer:
    """One weight-bearing network layer as seen by the mapper."""

    name: str
    kind: str  # "conv" | "fc"
    rows: int  # weight-matrix rows  (= kx*ky*cin for conv)
    cols: int  # weight-matrix cols  (= cout)
    pixels: int  # output positions per input sample (1 for fc)
    in_hw: int = 0  # input feature-map height/width (conv)
    kx: int = 0
    ky: int = 0
    cin: int = 0
    stride: int = 1

    @property
    def weights(self) -> int:
        return self.rows * self.cols

    @property
    def macs_per_sample(self) -> int:
        return self.weights * self.pixels


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    layers: List[Layer]
    input_hw: int = 224

    @property
    def total_weights(self) -> int:
        return sum(l.weights for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs_per_sample for l in self.layers)

    def conv_layers(self) -> List[Layer]:
        return [l for l in self.layers if l.kind == "conv"]

    def fc_layers(self) -> List[Layer]:
        return [l for l in self.layers if l.kind == "fc"]


class _Builder:
    """Sequential CNN builder tracking feature-map size (Table II format)."""

    def __init__(self, name: str, hw: int = 224, cin: int = 3):
        self.name, self.hw, self.cin = name, hw, cin
        self.layers: List[Layer] = []
        self._n = 0

    def conv(self, k: int, cout: int, stride: int = 1, repeat: int = 1, pad: Optional[int] = None):
        for _ in range(repeat):
            p = (k // 2) if pad is None else pad
            out_hw = (self.hw + 2 * p - k) // stride + 1
            self._n += 1
            self.layers.append(
                Layer(
                    name=f"conv{self._n}",
                    kind="conv",
                    rows=k * k * self.cin,
                    cols=cout,
                    pixels=out_hw * out_hw,
                    in_hw=self.hw,
                    kx=k,
                    ky=k,
                    cin=self.cin,
                    stride=stride,
                )
            )
            self.hw, self.cin, stride = out_hw, cout, 1
        return self

    def pool(self, k: int, stride: int = 2):
        self.hw = (self.hw - k) // stride + 1 if k > stride else self.hw // stride
        return self

    def spp(self, bins: Sequence[int] = (7, 3, 2, 1)):
        # spatial pyramid pooling: output features = sum(b^2) * cin
        self.hw = int(sum(b * b for b in bins)) ** 0  # flag: handled in fc()
        self._spp_feats = sum(b * b for b in bins) * self.cin
        return self

    def fc(self, cout: int, repeat: int = 1):
        for _ in range(repeat):
            rows = getattr(self, "_spp_feats", None) or self.hw * self.hw * self.cin
            self._spp_feats = None
            self._n += 1
            self.layers.append(
                Layer(name=f"fc{self._n}", kind="fc", rows=int(rows), cols=cout, pixels=1)
            )
            self.hw, self.cin = 1, cout
        return self

    def build(self) -> Network:
        return Network(self.name, self.layers)


def alexnet() -> Network:
    return (
        _Builder("alexnet")
        .conv(11, 96, stride=4, pad=2)
        .pool(3, 2)
        .conv(5, 256)
        .pool(3, 2)
        .conv(3, 384, repeat=2)
        .conv(3, 256)
        .pool(3, 2)
        .fc(4096, repeat=2)
        .fc(1000)
        .build()
    )


def vgg(cfg: str) -> Network:
    b = _Builder(f"vgg-{cfg.lower()}")
    plans = {
        # Simonyan & Zisserman configs A-D [28] (Table II columns)
        "a": [(64, 1)], "b": [(64, 2)], "c": [(64, 2)], "d": [(64, 2)],
    }
    n64 = {"a": 1, "b": 2, "c": 2, "d": 2}[cfg]
    n128 = {"a": 1, "b": 2, "c": 2, "d": 2}[cfg]
    b.conv(3, 64, repeat=n64).pool(2, 2)
    b.conv(3, 128, repeat=n128).pool(2, 2)
    b.conv(3, 256, repeat=2)
    if cfg == "c":
        b.conv(1, 256)
    elif cfg == "d":
        b.conv(3, 256)
    b.pool(2, 2)
    b.conv(3, 512, repeat=2)
    if cfg == "c":
        b.conv(1, 512)
    elif cfg == "d":
        b.conv(3, 512)
    b.pool(2, 2)
    b.conv(3, 512, repeat=2)
    if cfg == "c":
        b.conv(1, 512)
    elif cfg == "d":
        b.conv(3, 512)
    b.pool(2, 2)
    return b.fc(4096, repeat=2).fc(1000).build()


def msra(cfg: str) -> Network:
    """MSRA PReLU-nets A/B/C (He et al. [13]) per Table II."""
    b = _Builder(f"msra-{cfg.lower()}")
    b.conv(7, 96, stride=2, pad=3).pool(3, 2)
    if cfg == "a":
        b.conv(3, 256, repeat=5).pool(2, 2)
        b.conv(3, 512, repeat=5).pool(2, 2)
        b.conv(3, 512, repeat=5)
    elif cfg == "b":
        b.conv(3, 256, repeat=6).pool(2, 2)
        b.conv(3, 512, repeat=6).pool(2, 2)
        b.conv(3, 512, repeat=6)
    else:
        b.conv(3, 384, repeat=6).pool(2, 2)
        b.conv(3, 768, repeat=6).pool(2, 2)
        b.conv(3, 896, repeat=6)
    b.spp((7, 3, 2, 1))
    return b.fc(4096, repeat=2).fc(1000).build()


def resnet34() -> Network:
    b = _Builder("resnet-34")
    b.conv(7, 64, stride=2, pad=3).pool(3, 2)
    b.conv(3, 64, repeat=6)
    b.conv(3, 128, stride=2)
    b.conv(3, 128, repeat=7)
    b.conv(3, 256, stride=2)
    b.conv(3, 256, repeat=11)
    b.conv(3, 512, stride=2)
    b.conv(3, 512, repeat=5)
    b.pool(7, 7)  # global average pool
    return b.fc(1000).build()


def benchmark_suite() -> List[Network]:
    """The paper's Table II suite in presentation order."""
    return [
        alexnet(),
        vgg("a"),
        vgg("b"),
        vgg("c"),
        vgg("d"),
        msra("a"),
        msra("b"),
        msra("c"),
        resnet34(),
    ]


def by_name(name: str) -> Network:
    for n in benchmark_suite():
        if n.name == name:
            return n
    raise KeyError(name)


# ---------------------------------------------------------------------------
# LM architectures as crossbar workloads (framework integration)
# ---------------------------------------------------------------------------

def lm_workload(cfg, seq_len: int = 1) -> Network:
    """Extract the per-token VMM workload of an LM architecture config.

    Every projection of the model becomes an ``fc`` layer (decode-style: one
    token => pure VMM, the crossbar's natural shape).  MoE layers contribute
    only their activated experts (top-k + shared) — the in-situ array stores
    all experts but only activated columns draw ADC conversions.

    ``cfg`` is a ``repro_torch.configs.base.ModelConfig``.
    """
    layers: List[Layer] = []

    def fc(name, rows, cols, count=1):
        if rows and cols and count:
            layers.append(Layer(name=name, kind="fc", rows=int(rows), cols=int(cols), pixels=int(count)))

    d = cfg.d_model
    for i, blk in enumerate(cfg.block_pattern_summary()):
        p = f"L{i}.{blk}"
        if blk in ("attn", "attn_local", "attn_global"):
            h = cfg.head_dim * cfg.n_heads
            kvh = cfg.head_dim * cfg.n_kv_heads
            if cfg.kv_lora_rank:  # MLA
                fc(p + ".q", d, h)
                fc(p + ".kv_down", d, cfg.kv_lora_rank + cfg.qk_rope_dim)
                fc(p + ".kv_up", cfg.kv_lora_rank, 2 * h)
                fc(p + ".o", h, d)
            else:
                fc(p + ".q", d, h)
                fc(p + ".k", d, kvh)
                fc(p + ".v", d, kvh)
                fc(p + ".o", h, d)
        elif blk == "mamba":
            d_in = cfg.mamba_d_inner or 2 * d
            fc(p + ".in", d, 2 * d_in)
            fc(p + ".x", d_in, cfg.mamba_dt_rank + 2 * cfg.mamba_d_state)
            fc(p + ".out", d_in, d)
        elif blk in ("mlstm", "slstm"):
            d_in = cfg.xlstm_d_inner or 2 * d
            fc(p + ".qkv", d, 3 * d_in)
            fc(p + ".gates", d, 2 * d_in)
            fc(p + ".out", d_in, d)
        if blk.startswith("attn") or blk in ("mlstm", "slstm", "mamba"):
            if cfg.moe_experts and cfg.moe_layer(i):
                active = cfg.moe_top_k + cfg.moe_shared_experts
                fc(p + ".router", d, cfg.moe_experts)
                fc(p + ".ffn_in", d, 2 * cfg.moe_d_ff, count=active)
                fc(p + ".ffn_out", cfg.moe_d_ff, d, count=active)
            elif cfg.d_ff:
                fc(p + ".ffn_in", d, 2 * cfg.d_ff)
                fc(p + ".ffn_out", cfg.d_ff, d)
    fc("lm_head", d, cfg.vocab_size)
    net = Network(f"lm-{cfg.name}", layers, input_hw=0)
    return net
