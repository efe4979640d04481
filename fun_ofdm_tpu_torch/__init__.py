"""fun_ofdm_tpu_torch: the 802.11a OFDM PHY of fun_ofdm_tpu, in PyTorch.

The port runs, on an NVIDIA H100, the transmit side (`build_frame_p`
and, for bursts of mixed lengths, `build_frames_mixed_p`), the dense
capture receive (frame detection and decode), the header-driven dynamic
and any-rate decoders (the latter's soft streams by one table gather,
on the card one kernel), CFO correction, the streaming receiver chain
(`runtime.chain.ReceiverChain`),
sample I/O over a loopback bus, files and UDP (`runtime.io`), the channel
simulator with its BER/PER harness (`sim`), and the user API of
fun_ofdm_tpu: `Transmitter` and `Receiver` (`api`), with the five example
programs as `python -m fun_ofdm_tpu_torch.examples.{sim,tx,rx,transceiver,
capture}`. The chain's adaptive superstep ladder
(`ChainParams.latency_target_ms`) delivers sparse streams without waiting
out a full superstep; `parallel` receives a capture sharded over a
(channel, time) mesh of torch.distributed ranks, one device each. The
Viterbi is hand-written CUDA (`csrc/viterbi.cu`: the exact decode, the
block-overlap decode, and the ACS ablation variants of the A/B harness
`tools.viterbi_acs_ab`). Its modules mirror fun_ofdm_tpu's (`ops/`,
`models/`, `runtime/`, `parallel/`, `sim/`, `utils/`, `api`);
fun_ofdm_tpu is the reference it is tested against.

Entry points take `device` and default to "cuda" (a rank's mesh to
"cuda:<local rank>"); none moves to the CPU when it finds no GPU.

The rate table, the preamble, the chain configuration, the wire formats,
the native chunker and the sample I/O are the port's own copies of
fun_ofdm_tpu's; `Rate` is an IntEnum with the same values, so rates of the
two packages compare equal. Importing this package imports neither jax nor
anything of fun_ofdm_tpu, builds nothing and needs no GPU; `Transmitter`,
`Receiver` and the runtime's names are served lazily, as fun_ofdm_tpu
serves them.
"""

from .rates import Rate, RateParams, params_for, from_rate_field  # noqa: F401
from .config import ChainParams, DEFAULT_PARAMS  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # the facades and the runtime load on first use: importing the package
    # stays as light as its rate table
    if name in ("Transmitter", "Receiver"):
        from . import api
        return getattr(api, name)
    if name in ("ReceiverChain", "DecodedPacket", "LoopbackRadio",
                "RadioParams", "FileSource", "FileSink"):
        from . import runtime
        return getattr(runtime, name)
    raise AttributeError(name)
