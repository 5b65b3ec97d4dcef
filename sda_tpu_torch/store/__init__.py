"""L6: client-side key/identity storage."""

from .file import Filebased
