"""How much each part of a background checkpoint write slows a loop that
launches small kernels from the main thread, on the card.

A 1.32 GB state (600 f32 tensors, BERT-base's checkpoint size) lives on
the card; the main thread launches elementwise kernels for as long as
each piece of a write takes alone, while a second thread runs that
piece. Prints each piece's time alone and beside the loop, and the
loop's launch rate against its rate with nothing beside it:

    python3 tools/torch_save_probe.py

Pieces: a pinned allocation (600 buffers, then one), a copy of the state
into pinned buffers on a stream of its own, a copy into pageable memory,
the crc32 manifest's sums, and ``torch.save`` of the host copy.
"""

import os
import shutil
import tempfile
import threading
import time
import zlib

import torch


def main():
    dev = torch.device("cuda")
    state = {f"t{i}": torch.randn(550_000, device=dev) for i in range(600)}
    host = {k: v.cpu() for k, v in state.items()}
    pinned = {k: torch.empty(v.shape, pin_memory=True)
              for k, v in state.items()}
    x = torch.zeros(256, device=dev)
    torch.cuda.synchronize()
    out_dir = tempfile.mkdtemp()

    def loop(seconds):
        nonlocal x
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                x = x * 1.0001
            n += 100
            if n % 5000 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    def pin_alloc():
        [torch.empty(v.shape, pin_memory=True) for v in state.values()]

    def pin_alloc_one():
        torch.empty(600 * 550_000, pin_memory=True)

    def pinned_d2h():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for k, t in state.items():
                pinned[k].copy_(t, non_blocking=True)
        s.synchronize()

    def pageable_d2h():
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            for t in state.values():
                t.to("cpu")
        s.synchronize()

    def crc():
        for t in host.values():
            zlib.crc32(t.numpy().view("uint8"))

    def save():
        torch.save(host, os.path.join(out_dir, "state.pt"))

    base = loop(1.0)
    print(f"{torch.cuda.get_device_name(0)}; baseline {base:.0f} "
          "launches/s", flush=True)
    for name, fn in (("pinned alloc x600", pin_alloc),
                     ("pinned alloc one 1.32 GB", pin_alloc_one),
                     ("pinned copy, own stream", pinned_d2h),
                     ("pageable copy", pageable_d2h),
                     ("crc32", crc), ("torch.save", save)):
        t0 = time.perf_counter()
        fn()
        alone = time.perf_counter() - t0
        beside = []

        def work(fn=fn):
            t1 = time.perf_counter()
            fn()
            beside.append(time.perf_counter() - t1)
        th = threading.Thread(target=work)
        th.start()
        rate = loop(max(alone, 0.3))
        th.join()
        print(f"{name}: alone {alone:.3f} s, beside the loop "
              f"{beside[0]:.3f} s, loop at {rate / base:.2f} of its rate",
              flush=True)
    shutil.rmtree(out_dir)


if __name__ == "__main__":
    main()
