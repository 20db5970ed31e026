"""Entries: the system under test for a traffic mix, one module each,
found by the mix's ``entry`` name. Whatever is specific to a program lives
in its entry module: the harness (``run.py``, ``compare.py``,
``program_trace.py``) names none of it, so a cell of a new program is new
files only. Importing the module loads the program.

An entry module holds:

- ``Entry(cfg, mix, bank, device, log)``: the program built for the
  configuration and its bank, ``B`` frames a batch. ``set_pool(pool)``
  takes the cell's ``frames.Pool`` and sets ``n_batches``;
  ``calibrate()`` applies the configuration's rules over the pool;
  ``dispatch(i)`` starts pool batch ``i % n_batches`` and returns a handle;
  ``finalize(handle, rows)`` returns (frames returned, {row: answer} of
  the given rows); ``summary()`` is set-up's log line; ``shapes()`` what
  the per-layer readers count work from; ``reference_state()`` the plain
  values the reference needs from the program's set-up (a threshold it
  chose, its slots), taken before ``free()``, which drops the program.
  Optional: ``program_spans(on)`` switches the program's own spans on
  (True) or off (False) and, on the way off, returns (the spans recorded
  since they went on, the counters' increments); the traced run makes
  ``program_trace.py``'s passes only for an entry that has it.
- ``load_kernels()``: builds or loads the program's kernels for the card.
- ``reference_answers(cfg, bank, pool, sample, state, device, precision)``:
  the plain reference's answer of each sampled pool frame, {frame:
  answer}, made from the pool, the bank and ``state`` alone.
- ``compare(got, want, pool, sample)``: the compared numbers by the names
  of the cell's limits (``compare.judge`` holds them to the limits).
- ``CONTROL``: the precision in which ``bench_port/control.py`` runs the
  reference as the control.
"""
