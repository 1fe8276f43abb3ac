"""Device-side programs. Importing any ops module enables the persistent
JAX compilation cache (mumemto_tpu/jaxconfig.py): a scan's programs then
compile once per shape bucket."""

from mumemto_tpu.jaxconfig import ensure_cache

ensure_cache()
