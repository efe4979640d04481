"""Entry `capture_anyrate`: models.frontend.receive_capture_anyrate_p,
closed loop.

The capture entry (entries/capture.py) with the universal decode in place
of the known-rate one: each call decodes a recording with every frame's
rate and length read from its SIGNAL header, over the configuration's
`decode_rates` up to its `max_length`, at the program's default strategy
and parameters, and reads back starts, valid, payload, crc_ok, header_ok,
rate_field and hdr_length.

The check is the capture entry's, on each answer as the header gives it:
a delivered frame is (payload[:hdr_length], the rate of rate_field,
hdr_length). Before the capture entry's comparison, each kept output is
put in the known-rate form it compares: a slot whose header is not the
planted frame's (rate field and length) counts as not delivered, and the
payload is cut to the planted length. So a noiseless frame delivered with
another header, rate or length is wrong; a noisy frame answers as the
plain receiver's float64 decode does whenever its header is read as
planted or its CRC fails (a misread header that passes the CRC-32 would be
counted against the program).

After the profiled slice of a --trace 1 run, finish() runs trace_steps
more calls with the program's tracer on (fun_ofdm_tpu_torch/utils/trace.py;
never under the profiler, so the device rows stay as they are) and keeps
its span summary, its counters and the data symbols the decoded frames'
headers need, for the per-layer metrics. A program whose tracer has no
such spans or counters leaves those metrics out.
"""

from __future__ import annotations

from phybench.entries import capture
from phybench.reference import phy

#: read back besides the capture entry's keys
HEADER_KEYS = ("rate_field", "hdr_length")


class Driver(capture.Driver):
    def __init__(self, ctx):
        from fun_ofdm_tpu_torch.models import frontend
        from fun_ofdm_tpu_torch.rates import Rate

        rates = tuple(Rate[n] for n in ctx.config["decode_rates"])
        max_length = int(ctx.config["max_length"])
        anyrate = frontend.receive_capture_anyrate_p
        self._out = None

        def receive(stream, rate, length, frames):
            # the header gives each frame's rate and length
            self._out = anyrate(stream, rates, max_length, frames)
            return self._out
        self._receive = receive
        self._program: dict = {}
        super().__init__(ctx)

    def _call(self, i: int, spans) -> None:
        # the capture entry's call with receive_capture_anyrate_p in place
        # of the receive_capture_p it sets, then the header fields read
        # back into the outputs it kept
        self.receive = self._receive
        super()._call(i, spans)
        out, self._out = self._out, None
        with spans("readback"):
            self.recent[-1][1][1].update(
                {k: out[k].cpu().numpy() for k in HEADER_KEYS})

    def finish(self, spans) -> None:
        from fun_ofdm_tpu_torch.utils import trace

        trace.take()
        trace.enable()
        try:
            need = 0
            for _ in range(int(self.ctx.traffic["trace_steps"])):
                self._step(spans)
                need += header_symbols(self.recent[-1][1][1])
        finally:
            trace.disable()
        recorded, counters = trace.take()
        self._program = {"program_spans": trace.summary(recorded),
                         "program_counters": counters,
                         "symbols_needed": need}

    def counters(self) -> dict:
        return {**self._slice, **self._program}

    def outcome(self, rng, device):
        t = self.t
        field = phy.RATES[t.rate][1]
        seen = set()
        for _, (_, host) in self.sample + list(self.recent):
            if id(host) not in seen:
                seen.add(id(host))
                as_planted(host, field, t.length)
        return super().outcome(rng, device)


def as_planted(host: dict, rate_field: int, length: int) -> None:
    """The universal decode's outputs in the capture entry's form, in
    place: crc_ok and header_ok only where the header gives the planted
    rate field and length, the payload cut to that length."""
    same = (host["rate_field"] == rate_field) & (host["hdr_length"] == length)
    host["header_ok"] = host["header_ok"] & same
    host["crc_ok"] = host["crc_ok"] & same
    host["payload"] = host["payload"][..., :length]


def header_symbols(host: dict) -> int:
    """Data symbols the slots' headers call for (slots whose header holds),
    from the read-back rate fields and lengths, by the plain reference's
    rate table."""
    ok = host["header_ok"].reshape(-1)
    fields = host["rate_field"].reshape(-1)[ok]
    lengths = host["hdr_length"].reshape(-1)[ok]
    return int(sum(phy.num_symbols(phy.RATE_BY_FIELD[int(f)], int(n))
                   for f, n in zip(fields, lengths)))
