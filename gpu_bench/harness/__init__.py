"""The benchmark's own code: the cell's files, the inputs, the timed stream,
the reading of the trace, the frozen work counts, the reference and the check.

Only ``stream`` imports the program (``tiger_tpu_torch``); ``reference``,
``check`` and the models under ``gpu_bench/models`` import neither it nor JAX.
"""
