"""The benchmark's plain reference: an independent plain-PyTorch renderer
of the same semantics as the program under test, frozen here so that a
later change to the program cannot move the yardstick.

It imports nothing of the program.  It covers what the benchmark's cells
drive: the scene and its pose (:mod:`.scene`), the procedural disk texel,
tint and star sky (:mod:`.procedural`), the plain Euler and Cash-Karp
RK45 march and the exact-Kerr one (:mod:`.march`, :mod:`.kerr`), the disk
composite and the sky (:mod:`.shade`),
the tracer's straight and march phases (:mod:`.tracer`), the adaptive
ladder, whose levels march only the rays they re-trace, compacted
(:mod:`.frame`), the post chain (:mod:`.post`), and the fit step
(:mod:`.fit`).  Every function runs on the device of its inputs.
"""
