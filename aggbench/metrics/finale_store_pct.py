"""The finale's store's share of the window: the union of the program's
``stream.finale.store`` ranges (``mesh/streaming.py::_drive_stream``: the
host write of a tile's values into the round's output array) over the
window of complete rounds."""


def read(view):
    store = view.range_us("stream.finale.store")
    if not store or view.window_us <= 0:
        return None
    return 100.0 * store / view.window_us
