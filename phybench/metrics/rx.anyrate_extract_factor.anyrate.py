"""Data symbols the universal decode extracted and equalised (the program's
anyrate.symbols counter: slots x the slowest rate's symbols at
max_length) over those the decoded frames' headers call for (read-back
rate_field and hdr_length of the slots whose header holds), in the
entry's pass with the program's tracer on. 1 is no waste. None where the
program counts no anyrate.symbols."""


def read(run):
    counted = (run.counters.get("program_counters") or {}).get(
        "anyrate.symbols")
    need = run.counters.get("symbols_needed")
    if not counted or not need:
        return None
    return counted / need
