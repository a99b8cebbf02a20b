# Common targets. Tests force the CPU platform with a virtual 8-device mesh;
# bench and smoke need a GPU.
PY ?= python

.PHONY: test bench smoke native lint dryrun

test:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

# builds wavefarm/native/build/libwafer_native.so from src/wafer_native.cpp
native:
	$(PY) -c "from wavefarm import native; assert native.available(); print('native codecs OK')"

dryrun:
	$(PY) __graft_entry__.py 4

lint:
	$(PY) -m compileall -q wavefarm tests
