"""Host-side utilities: ``device`` (device choice, f32 numerics policy),
``images`` (image IO and crops, needs Pillow), ``colors`` (luminance-only
transfer and CORAL), ``profiling`` (synchronised stage timers, the
profiler trace), ``serving`` (``BucketedStylizer``: any image size through
bucketed shapes) and ``stream`` (``StreamStylizer``: the video engine with
submit-ahead on CUDA streams; ``VideoSource``: capture, needs cv2).

Importing this package imports none of them: cv2 loads only when a
``VideoSource`` opens, and Pillow only with ``images`` (which ``stream``
uses to resize frames)."""
