"""Frames integrated per second in the traced run's window, closed loop,
fenced at its end: the rate a robot's mapper sustains. It is paced by
the host, whose speed moves it by more than a bound can hold, so it is
read here and the card's time per frame stands end to end."""

MOVES = "device_ms_per_frame"
UNIT = "frames/s"


def read(rec):
    return rec.get("frames_per_s")
