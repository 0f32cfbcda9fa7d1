"""The reference decodes, warps and erodes with PIL and cv2 alone: the
port's C++ plugin is reported as absent here, so every `native` branch of
the copied modules takes its PIL / cv2 path."""


def available():
    return False
