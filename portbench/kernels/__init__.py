"""One file per hand kernel of the port: ``NAME``; ``PATTERN``, a regular
expression that finds its device operations in a trace by name;
``LAUNCHES``, its key in ``mies_tpu_torch.kernels._build.LAUNCHES``; and
``work(w)`` -> (bytes, operations) of one batch (a ``harness.Work``), or
None where the chain runs no stage the kernel serves. The count is the
stage's work: its input read once, its output written once, its
operations at the reference stage files' counts. A kernel that computes
several stages counts them as one: the first stage's input, the last
stage's output, the operations summed."""
