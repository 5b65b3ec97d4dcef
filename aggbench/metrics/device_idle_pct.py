"""The device's idle share of the window: one less the union of its
events (kernels, copies, memsets) over the window of complete rounds."""


def read(view):
    busy = view.busy_us()
    if not busy or view.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy / view.window_us)
