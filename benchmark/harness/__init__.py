"""The benchmark's machinery: discovery of cells, configurations, entries
and metrics by file name (:mod:`.cells`), the models of both sides and
their seeded weights (:mod:`.models`), the seeded inputs (:mod:`.data`),
the reduction of a profiler trace (:mod:`.trace`), the comparison
helpers (:mod:`.compare`) and the run of one cell (:mod:`.launch`)."""
