"""Data symbols the chain's universal decodes extracted and equalised (the
program's anyrate.symbols counter: each bucket's slots, padding included,
x its length class's slowest symbol count at max_length) over those the
dispatched frames' headers call for (anyrate.symbols_needed), in the
entry's pass with the program's tracer on. 1 is no waste. None where the
program counts either not."""


def read(run):
    counted = run.counters.get("program_counters") or {}
    symbols = counted.get("anyrate.symbols")
    need = counted.get("anyrate.symbols_needed")
    if not symbols or not need:
        return None
    return symbols / need
