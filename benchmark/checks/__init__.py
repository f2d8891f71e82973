"""One module per kind of ``correct`` check, found by the name that a
configuration's ``check`` block gives as ``kind`` (``image`` where it gives
none), as launchers are found by their mix and metrics by their entry.

Each holds ``judge(cell, measured, seed, device="cuda", dtype=None)``,
which returns (compared numbers, checks, diagnostics) of a launcher's
:class:`benchmark.launchers.common.Measured`: ``checks`` maps each number
compared and each guard, in the order they print, to its ``value`` and
``limit`` (``check.passed`` decides on them), and ``dtype``, where it is a
lower precision, puts the kind's own reference computed in it in the
program's place (the control). ``control(cell, seed, n, device)`` gives the
control's numbers without the program, over ``n`` units of the kind's work
(``python3 -m benchmark.control --spp n``). A kind reads what its
launchers hand it: the fields of ``Measured`` it names, or ``extra``.
"""
