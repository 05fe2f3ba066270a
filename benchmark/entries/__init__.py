"""The request kinds, one module a kind, found by a traffic mix's
``entry``: the harness imports ``benchmark.entries.<entry>``, so a new kind
is a new file here.  A kind's module holds:

- ``ENTRY``: the closed loop with one client, built in set-up as
  ``ENTRY(epochs, gt, config, traffic, workdir, dev, seconds, devices=...,
  children=...)``.  ``dev`` is ``devices[0]``; ``devices`` the cell's
  ``chips`` cards (``cuda:0`` ... on the card, ``cpu`` in the CPU tests);
  ``children`` a :class:`benchmark.child.Children` for command lines of the
  program run in processes of their own on those cards, which the harness
  measures with its own.  ``warm()`` runs the cell's own shapes once,
  inside set-up; ``request(k)`` runs the k-th request to its end and
  returns what the judge reads, with ``units``, the work it completed in
  the unit of the cell's rate; a request that raises has failed.  An
  optional ``close()`` runs after the window, before the judge (children
  still open then are closed by the harness).  These are the only places
  that call the program.
- ``JUDGE(answers, epochs, gt, cell, seed, dev)``: the numbers the run
  compares (:mod:`benchmark.judge`), with ``answers_checked``.
- ``CHECKS``: the names of those numbers, each with its limit in
  ``limits/<cell>.json``.
- ``CONTROL(cell, epochs, gt, seed, dev)``: the same numbers with the plain
  reference, in the precision below the configuration's, in the program's
  place (``benchmark/control.py``).
"""
