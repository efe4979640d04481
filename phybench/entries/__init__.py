"""Entry drivers: one module per entry of the program that a cell drives.

A traffic file names its driver ("entry"); the harness loads
phybench/entries/<entry>.py and uses its `Driver`:

  Driver(ctx)                    set-up: the program's objects, built once,
                                 and a warm-up of every shape the cell uses
  window(seconds, spans, close)  the measured window; returns the cell's
                                 end-to-end numbers; close=True ends the
                                 stream inside it
  traced(spans)                  the profiled slice of a --trace 1 run
  finish(spans)                  ends the stream after a traced slice
  counters()                     what the traced slice did, for the
                                 per-layer metrics
  outcome(rng, device)           after the window: frees the program's
                                 state and returns (attempted: the frames
                                 compared, failed, the numbers compared);
                                 see phybench/check.py
"""
