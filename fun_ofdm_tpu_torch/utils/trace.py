"""The port's tracer: named spans at the program's layer boundaries.

The counterpart, inside the program, of fun_ofdm_tpu/utils/profiling.py's
Timer. There is one tracer per process, off by default. Off, `span()`
checks one module flag and returns a shared no-op context: no clock read,
no allocation, no profiler call.

Tracing a ReceiverChain (or the capture entry):

    from fun_ofdm_tpu_torch.utils import trace

    trace.enable()
    for piece in pieces:
        chain.process_samples(piece)
    chain.flush()
    spans, counters = trace.take()        # and clears them
    trace.disable()
    for name, (count, total_ms, self_ms) in trace.summary(spans).items():
        print(f"{name}: {count} spans, {total_ms:.3f} ms, self {self_ms:.3f}")

Each span is a `Span(name, id, parent, t0_ns, t1_ns)` on
time.perf_counter_ns. `parent` is the index, in the list take() returns,
of the span that was open on the same thread when this one began (-1 at a
root). `id` is the request: the chain gives a dispatch its stream position
(`gpos`), so that one superstep's ingest, header wait, decode dispatch,
decode wait and collection share an id across calls; a span given no id
takes its parent's, and a root given none the number of roots of its name
recorded before it since the last take() (the capture entry's call index).
At most LIMIT spans are kept between two take() calls; `counters["dropped"]`
counts the spans past it. Call take() between calls into the program: a
span still open then is not returned.

`count(name, n)` adds n to a named counter while the tracer is on (off, it
returns at once). take() returns each counter's total since the last
take() beside `dropped`; a counter never counted is absent.

While a torch.profiler is active, each span is also a record_function
annotation of its name, so the program's spans lie on the device trace's
timeline: an idle gap of the device can be named by the span the host was
in, and a kernel by the span that launched it.

The spans, by layer (the names of PERF.md's list of layers):

  chain.process_samples, chain.flush   roots: one call into the chain
  native.chunk      the native chunker's push/pop loop (chain.ingest
                    nests in it)
  chain.ingest      one dispatch (id gpos): wire.pack (int10/int12 packing
                    or quantization on the host), chain.h2d (the copy to
                    the card and the window roll), frontend.decode_headers
                    (the enqueue of the detection + header pass)
  chain.drain       the pipeline's synchronisation: chain.wait (each wait
                    for a result copied to the host; its parent names the
                    stage), chain.header_overflow, rx.decode (each decode
                    bucket's dispatch, id gpos), chain.collect (id gpos;
                    viterbi.redecode_exact inside it)
  frontend.receive_capture   root of the capture entries (receive_capture,
                    receive_capture_dynamic_p, receive_capture_anyrate_p):
                    frontend.detect, rx.decode
  rx.anyrate_sync   inside the universal decode (rx.decode_frames_anyrate):
                    extraction, FFT, equalisation and the SIGNAL header
                    of every slot at the slowest rate's longest frame
  ppdu.anyrate_coded   the universal decode's soft streams at each frame's
                    rate (on the card one kernel launch; on the CPU one
                    all-modulation demodulation and a table gather)
  viterbi.exact, viterbi.blocked   the CUDA Viterbi's C entry points
  Inside a capture call's rx.decode on the card, rx.anyrate_sync,
  ppdu.anyrate_coded and viterbi.exact open only on a key's first call
  (rx.decode_eager, rx.graph_captures: the eager decode, then the
  capture's pass); a replay (rx.graph_replays) runs none of that Python
  and opens no span inside rx.decode.

The counters, all known on the host (no sync):

  anyrate.slots        slots the universal decode decoded
  anyrate.symbols      data symbols it extracted and equalised: slots x
                       the slowest rate's symbols at max_length
  anyrate.kernel_slots slots whose soft streams the kernel of
                       csrc/softbits.cu built (ops/softbits_cuda): equal
                       to anyrate.slots on the card, never counted on the
                       CPU
  rx.decode_eager      capture calls on the card whose decode ran eagerly:
                       a key's first call (models/rx.capture_call), and
                       every call of a dtype that takes no graph
  rx.graph_captures    CUDA graphs of the decode captured: one on a key's
                       first call, after its eager decode
  rx.graph_replays     capture calls on the card that replayed the graph
                       (every later call of the key)
  None of the three is counted on the CPU; a capture call on the card
  counts rx.decode_eager or rx.graph_replays. The anyrate.* counts of a
  capture call are made once a call, outside the decode, whether it runs
  eagerly or replays (rx.Decode.count).
  chain.decode_jobs    the chain's bucketed payload decodes (one a
                       bucket; a guard's exact re-decode not counted)
  chain.decode_slots   the slots of those buckets, padding included
  chain.decode_frames  the owned frames among them
  anyrate.symbols_needed   in the chain's universal mode, the data
                       symbols the dispatched frames' headers call for
                       (num_symbols of each header's rate and length):
                       anyrate.symbols over it is the extraction's waste
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

#: spans kept between two take() calls; the rest are counted as dropped
LIMIT = 1 << 18


class Span(NamedTuple):
    name: str
    id: int | None
    #: index of the enclosing span in take()'s list; -1 for a root
    parent: int
    t0_ns: int
    t1_ns: int


_enabled = False
_records: list = []             # [name, id, parent record, t0, t1]
_dropped = 0
_counts: dict = {}              # counter totals since the last take()
_roots: dict = {}               # root spans recorded so far, by name
_local = threading.local()      # .stack: the open records of a thread


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "rec", "rf")

    def __init__(self, name: str, id: int | None):
        self.name, self.id, self.rec, self.rf = name, id, None, None

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if len(_records) >= LIMIT:
            _dropped += 1
            return None
        parent = stack[-1] if stack else None
        sid = self.id
        if sid is None:
            if parent is not None:
                sid = parent[1]
            else:
                sid = _roots.get(self.name, 0)
                _roots[self.name] = sid + 1
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = [self.name, sid, parent, time.perf_counter_ns(), 0]
        _records.append(self.rec)
        stack.append(self.rec)
        return None

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[4] = time.perf_counter_ns()
            _local.stack.pop()
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
        return False


def span(name: str, id: int | None = None):
    """A context that records one span of `name` while the tracer is on,
    and the shared no-op context while it is off."""
    if not _enabled:
        return _OFF
    return _On(name, id)


def count(name: str, n: int) -> None:
    """Add n to counter `name` while the tracer is on; off, do nothing."""
    if _enabled:
        _counts[name] = _counts.get(name, 0) + n


def enabled() -> bool:
    """Whether the tracer is on: a count that costs host work to compute
    is computed only then."""
    return _enabled


def enable() -> None:
    """Turn the tracer on (spans recorded until disable())."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn the tracer off; what was recorded stays for take()."""
    global _enabled
    _enabled = False


def take() -> tuple[list[Span], dict]:
    """The spans closed since the last take(), in the order they began,
    and the counters ({"dropped": spans past LIMIT} and the totals of
    count()); clears both."""
    global _records, _dropped, _counts, _roots
    recs, dropped, counts = _records, _dropped, _counts
    _records, _dropped, _counts, _roots = [], 0, {}, {}
    closed = [r for r in recs if r[4]]
    index = {id(r): i for i, r in enumerate(closed)}
    spans = [Span(r[0], r[1], -1 if r[2] is None else index.get(id(r[2]), -1),
                  r[3], r[4]) for r in closed]
    return spans, {"dropped": dropped, **counts}


def summary(spans: list[Span]) -> dict:
    """{name: (count, total ms, self ms)}: a span's self time is its
    duration less its children's."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.t1_ns - s.t0_ns
    out: dict = {}
    for s, c in zip(spans, child_ns):
        n, total, own = out.get(s.name, (0, 0.0, 0.0))
        dur = (s.t1_ns - s.t0_ns) / 1e6
        out[s.name] = (n + 1, total + dur, own + dur - c / 1e6)
    return out
