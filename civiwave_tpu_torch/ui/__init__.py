from .session import InteractiveSession, PointLoadRequest  # noqa: F401
