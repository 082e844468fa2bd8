"""Plain references of their own, one module a configuration names.

A configuration file whose top-level key ``"reference"`` is ``"<name>"``
is judged by the module ``portbench.references.<name>``
(``portbench/references/<name>.py``); one without the key by
``portbench.reference``.  ``harness.context`` puts the module in the run's
context as ``ctx.ref`` and the configuration's format as
``ctx.fmt = ctx.ref.Format.from_config(cfg)``, and the entries call every
reference function through ``ctx.ref``.

A reference module defines:

- ``Format``, a class whose ``from_config(cfg) -> Format`` reads the
  configuration's ``encoder`` settings and raises ``ValueError`` on any it
  cannot judge.  It carries the fields and properties of
  ``portbench.reference.Format`` (a subclass of it does);
- ``choose(pcm, fmt, precision=None) -> (channel code, [Subframe])``: the
  encoder's choices for one frame ``pcm [C, n]`` worked out again from the
  PCM by the configuration's algorithm, at the analysis precision it
  states, or at ``precision`` (the configuration's ``control``).

It also holds, defined or taken from ``portbench.reference``, what the
entries call beside ``choose``:

- ``check_frame(frame, fmt, pcm, index) -> (fields or None, why or None)``;
- ``channel_signals(pcm, fmt, code) -> (signals, widths)``;
- ``residual(x, kind, order, coefs=(), shift=0) -> residual``;
- ``zigzag(r)``;
- ``rice_optimum(zz, order, fmt) -> RicePlan``;
- ``write_frame(pcm, fmt, index, code, subframes) -> bytes`` (the encode
  entry's control writes ``write_frame(pcm, fmt, index, *choose(pcm, fmt,
  precision))``);
- ``decode_frame(frame, fmt, arithmetic=None) -> [C, n] int64``;
- ``stream_bytes(frames, fmt, total_samples) -> bytes``.

Like ``portbench.reference`` it imports nothing of the program and takes
nothing the program made but the outputs it judges.
"""
