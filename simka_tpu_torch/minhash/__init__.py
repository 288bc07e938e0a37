"""SimkaMin on one device: seeded bottom-s MinHash sketches of every
sample (``min sketch``), and the sketch file's ``info`` and ``append``.

``murmur.py``, ``sketch_file.py`` and the replay of ``bloom.py`` are
numpy copies of ``simka_tpu.minhash``'s host modules; ``device.py``
holds the device programs in torch around the MurmurHash3 kernel
(``csrc/minhash.cu``) and the compaction (``csrc/compact.cu``);
``sketch.py`` the drivers; ``pipeline.py`` and ``cli.py`` the commands.
"""
