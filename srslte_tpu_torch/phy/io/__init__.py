from .filesource import FileSink, FileSource  # noqa: F401
