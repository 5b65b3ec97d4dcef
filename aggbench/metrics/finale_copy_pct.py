"""The finale's copy's share of the window: the union of the program's
``stream.finale.copy`` ranges (``mesh/streaming.py::_drive_stream``: the
wait for the reveal, the tile's device-to-host copy into pageable memory)
over the window of complete rounds."""


def read(view):
    copy = view.range_us("stream.finale.copy")
    if not copy or view.window_us <= 0:
        return None
    return 100.0 * copy / view.window_us
