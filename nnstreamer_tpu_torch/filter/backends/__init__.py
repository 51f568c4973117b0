"""Built-in filter backends.  Importing this package registers them (the
in-process analogue of subplugin .so discovery,
gst/nnstreamer/nnstreamer_subplugin.c:116).  The port has one so far."""

from .xla import XLAFilter

__all__ = ["XLAFilter"]
