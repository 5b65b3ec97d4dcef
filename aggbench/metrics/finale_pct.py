"""The streamed driver's finale's share of the window: the union of the
program's ``stream.finale`` ranges (``mesh/streaming.py::_drive_stream``:
the clerk combine K9 on a pod, the reveal K7, the copy of the aggregate to
the host) over the window of complete rounds."""


def read(view):
    finale = view.range_us("stream.finale")
    if not finale or view.window_us <= 0:
        return None
    return 100.0 * finale / view.window_us
