"""nnU-Net-style random patch sampler with foreground oversampling.

A copy of ``segmamba_tpu/data/patch_sampler.py``: random case selection
with replacement, the last 33% of each batch forced to contain foreground,
center voxel drawn from the precomputed ``class_locations``, crop-then-pad
to the patch size (image and seg padded 0; out-of-image voxels were marked
-1 by preprocessing). The crop is ``native.crop_pad``, as in the JAX
package: the C++ extension, or numpy when ``SEGMAMBA_DISABLE_NATIVE=1``
asks for it (the same values).
"""

from __future__ import annotations

import numpy as np

from segmamba_tpu_torch.native import crop_pad


class PatchSampler:
    def __init__(self, dataset, patch_size, batch_size=2,
                 oversample_foreground_percent=0.33,
                 probabilistic_oversampling=False, rng=None):
        self.dataset = dataset
        self.patch_size = tuple(int(p) for p in patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.probabilistic = probabilistic_oversampling
        self.rng = rng or np.random.default_rng()

    def _force_fg(self, sample_idx):
        if self.probabilistic:
            return self.rng.uniform() < self.oversample
        # last XX% of the batch (base_data_loader.py:137-141)
        return not sample_idx < round(self.batch_size * (1 - self.oversample))

    def get_bbox(self, shape, force_fg, class_locations):
        dim = len(shape)
        ps = self.patch_size
        pad = [max(0, ps[d] - shape[d]) for d in range(dim)]
        lbs = [-pad[d] // 2 for d in range(dim)]
        ubs = [shape[d] + pad[d] // 2 + pad[d] % 2 - ps[d] for d in range(dim)]
        if force_fg and class_locations is not None:
            eligible = [k for k, v in class_locations.items() if len(v) > 0]
            if eligible:
                cls = eligible[self.rng.integers(len(eligible))]
                voxels = class_locations[cls]
                v = voxels[self.rng.integers(len(voxels))]
                # v includes the channel dim at position 0 (argwhere on (1,Z,Y,X))
                lb = [int(max(lbs[d], v[d + 1] - ps[d] // 2))
                      for d in range(dim)]
                return lb, [lb[d] + ps[d] for d in range(dim)]
        lb = [int(self.rng.integers(lbs[d], ubs[d] + 1)) for d in range(dim)]
        return lb, [lb[d] + ps[d] for d in range(dim)]

    def sample_case(self, idx, force_fg):
        item = self.dataset[idx]
        data, seg = item["data"], item.get("seg")
        props = item["properties"]
        gvol = item.get("data_global")
        shape = data.shape[1:]
        lb, ub = self.get_bbox(shape, force_fg, props.get("class_locations"))
        # memmap-friendly: slice the valid region first, then crop_pad
        vlb = [max(0, l) for l in lb]
        vub = [min(shape[d], ub[d]) for d in range(len(shape))]
        sl = (slice(None),) + tuple(slice(a, b) for a, b in zip(vlb, vub))
        rel_lb = [lb[i] - vlb[i] for i in range(3)]
        d = crop_pad(np.asarray(data[sl], np.float32), rel_lb,
                     self.patch_size, 0.0)
        s = None
        if seg is not None:
            s = crop_pad(np.asarray(seg[sl], np.float32), rel_lb,
                         self.patch_size, 0.0)
        g = None if gvol is None else np.asarray(gvol, np.float32)
        return d, s, props, g

    def generate_train_batch(self):
        """One batch dict {'data': (B,C,*ps), 'seg': (B,1,*ps), 'properties',
        'keys'} — the reference's batch contract (base_data_loader.py:122-127)."""
        keys = self.rng.integers(0, len(self.dataset), self.batch_size)
        datas, segs, props, globals_ = [], [], [], []
        for j, k in enumerate(keys):
            d, s, p, g = self.sample_case(int(k), self._force_fg(j))
            datas.append(d)
            segs.append(s)
            props.append(p)
            if g is not None:
                globals_.append(g)
        batch = {
            "data": np.stack(datas).astype(np.float32),
            "properties": props,
            "keys": keys,
        }
        if segs[0] is not None:
            batch["seg"] = np.stack(segs).astype(np.float32)
        if globals_:
            # whole-volume context stream (base_data_loader.py:108-127)
            batch["data_global"] = np.stack(globals_)
        return batch

    def __next__(self):
        return self.generate_train_batch()
