"""SimkaMin on one device: seeded bottom-s MinHash sketches of every
sample (``min sketch``), the sketch file's ``info`` and ``append``, and
the Jaccard and Bray-Curtis matrices between sketches (``min
distance``, ``export``, ``pipeline``, ``update``, ``matrix-update``).

``murmur.py``, ``sketch_file.py``, ``distance.py`` and the replay of
``bloom.py`` are numpy copies of ``simka_tpu.minhash``'s host modules;
``device.py`` holds the sketch's device programs in torch around the
MurmurHash3 kernel (``csrc/minhash.cu``) and the compaction
(``csrc/compact.cu``); ``device_distance.py`` the sketch-pair distance
around its kernel (``csrc/min_distance.cu``); ``sketch.py`` the sketch
routes; ``pipeline.py`` and ``cli.py`` the commands.
"""
