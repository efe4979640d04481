"""Host time of the universal decode a capture call: the total ms of the
program's rx.decode spans over its frontend.receive_capture roots, from
the entry's pass with the program's tracer on (after the profiled slice).
None where the program opens no such spans."""


def read(run):
    spans = run.counters.get("program_spans") or {}
    if "rx.decode" not in spans or "frontend.receive_capture" not in spans:
        return None
    calls = spans["frontend.receive_capture"][0]
    return spans["rx.decode"][1] / calls if calls else None
