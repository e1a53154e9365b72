from .native import NativeRingBuffer, SamplePipeRx, SamplePipeTx, TtiClock  # noqa: F401
