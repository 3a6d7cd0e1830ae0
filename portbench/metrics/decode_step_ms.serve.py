"""The window's decode-step time over all its steps: each
``model.decode_step`` call's start to the engine's next model call (or
the window's end), on the benchmark's clock, in ms."""


def read(rec):
    xs = rec.get("run", {}).get("decode_step_s")
    return sum(xs) / len(xs) * 1e3 if xs else None
