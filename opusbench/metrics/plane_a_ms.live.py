"""plane_a_ms.live: host ms a step of plane A, the program's C++ entropy
decode of every stream into the step's plan slot (one call a step)."""

WRAPS = ("native.decode_batch_plan_into",)


def read(run):
    return run.span_ms(WRAPS[0])
