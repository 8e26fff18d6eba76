from opencv_opencl_tpu_torch.io.videofile import (
    FileSink,
    FileSource,
    NullSink,
    RawSink,
    TestSource,
)

__all__ = ["FileSink", "FileSource", "NullSink", "RawSink", "TestSource"]
