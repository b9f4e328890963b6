"""The data layer: vocabularies and phone maps, record files, the native
record reader and audio decoders, the bucketed batch pipeline, and the
corpora and their prep (the port's own copies of the reference's numpy
and C++ modules)."""
