from .filesource import FileSink, FileSource  # noqa: F401
from .net import NetSink, NetSource  # noqa: F401
