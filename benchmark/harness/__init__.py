"""The benchmark's shared machinery: the manifest and the files a cell names,
seeds, the device checks, spans and the profiler slice, and the comparisons
that decide ``correct``. Nothing here imports the measured program."""
