"""Driving the program: the loops a traffic mix can ask for, each a job
that sets up from the seed, issues one frame or one step at a time, and
compares what it produced with the plain reference.

``view`` (one interactive viewer): ``make_renderer(..., backend=...)`` and
``render(camera_matrices)`` a frame, synchronised before the next.
``fit`` (one fitting job): ``make_renderer(..., differentiable=True)``, the
L2 loss, ``backward()``, Adam, the projection onto [0, 1] and
``loss.item()``, the loop of the program's ``optim.fit_scene``.
``fit_ranks`` (one fitting job over one process per card): this process's
rank of ``parallel.mesh.make_train_step``'s all-reduced step, its
gradients put in the leaves' ``.grad``, then Adam, the projection and
``loss.item()``: ``parallel.launch.fit_distributed``'s loop with
``fit_scene``'s projection (``perfbench/ranks.py`` runs the processes).

This is the one module that imports the program, and only its entry
points: ``volym_tpu_torch.render.renderer.make_renderer``, ``Scene``,
``CameraMatrices``, ``RenderParams``, ``optim.l2_image_loss``,
``parallel.launch.maybe_initialize`` and ``local_device``, and
``parallel.mesh.make_host_mesh`` and ``make_train_step``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import check, inputs, reference, traffic

#: frames of an orbit compared with the reference: this many drawn from the
#: seed among the first SAMPLE_BELOW, and the last
SAMPLED_FRAMES, SAMPLE_BELOW = 3, 100
#: steps of a fitting job the reference follows: the first from the start
#: (the flat start's second and third steps turn rounding into gaps of up
#: to 1e-2, the reference against itself included), and WINDOW_STEPS
#: consecutive steps of the window, from the program's own state, at an
#: index drawn from the seed in [1, WINDOW_BELOW)
FIT_CHECKED_STEPS = 1
WINDOW_STEPS, WINDOW_BELOW = 2, 32


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Job:
    """Common to both loops: the configuration, the inputs, the cameras."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, backend: str):
        from volym_tpu_torch.config import RenderParams

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.backend = torch.device(device), backend
        self.height, self.width = int(cfg["height"]), int(cfg["width"])
        self.params = RenderParams(**cfg["params"])
        self.ref_params = reference.Params.from_config(cfg["params"])
        self.views = traffic.Views(mix, seed)
        self.volume, self.importance, self.volume_u8 = inputs.make_volume(cfg["volume"], seed, self.device)
        self.lut = torch.as_tensor(inputs.default_lut(), device=self.device)

    def matrices(self, i: int) -> dict:
        az, el = self.views.angles(i)
        return inputs.orbit_matrices(az, el, self.cfg["camera"], self.width / self.height)

    def port_matrices(self, m: dict):
        """The camera as the program takes it: float32 tensors on the host,
        as ``Camera.matrices()`` makes them."""
        from volym_tpu_torch.camera import CameraMatrices

        return CameraMatrices(*(torch.from_numpy(np.asarray(m[k], np.float32))
                                for k in ("view", "proj", "inverse_view_proj", "position")))

    def warm_angles(self) -> list[tuple[float, float]]:
        """Cameras that reach every march axis and direction the traffic
        can: every 45 degrees of azimuth at both ends of the elevations."""
        lo, hi = self.mix["elevation_range"]
        return [(az, el) for az in range(0, 360, 45) for el in (lo, hi)]

    def planes(self) -> int:
        return reference.plane_count(self.ref_params, int(self.cfg["volume"]["side"]))


class ViewJob(Job):
    def __init__(self, cfg, mix, seed, device, backend):
        super().__init__(cfg, mix, seed, device, backend)
        from volym_tpu_torch.render import renderer
        from volym_tpu_torch.scene import Scene, u8_record

        scene = Scene(volume=self.volume, importance=self.importance, tf_lut=self.lut, volume_u8=self.volume_u8,
                      u8_source=u8_record(self.volume, self.volume_u8))
        self.render = renderer.make_renderer(scene, self.params, self.height, self.width, backend=backend,
                                             device=self.device)
        self.sampled = traffic.sample_indices(seed, SAMPLED_FRAMES, SAMPLE_BELOW)
        self.kept = {i: torch.empty((self.height, self.width, 4), device=self.device) for i in self.sampled}
        self.last = None

    def warm_up(self):
        for az, el in self.warm_angles():
            m = inputs.orbit_matrices(az, el, self.cfg["camera"], self.width / self.height)
            self.sync(self.render(self.port_matrices(m)))

    def issue(self, i: int):
        return self.render(self.port_matrices(self.matrices(i)))

    def sync(self, out):
        _sync(self.device)

    def keep(self, i: int, out):
        if i in self.kept:
            self.kept[i].copy_(out)
        self.last = (i, out)

    def finish(self, count: int) -> int:
        return count

    def release(self):
        del self.render

    def numbers(self, dtype=torch.float32, program=None) -> dict[str, float]:
        """The frames compared after the window: those drawn from the seed
        that were rendered, and the last; ``program`` in place of the
        program's frames (the control)."""
        frames = {i: img for i, img in self.kept.items() if i <= self.last[0]}
        frames[self.last[0]] = self.last[1]
        got, want = [], []
        for i, img in sorted(frames.items()):
            m = self.matrices(i)
            ref, _ = reference.render(self.volume, self.importance, self.lut, m, self.ref_params, self.height,
                                      self.width)
            if program is not None:
                img, _ = reference.render(self.volume, self.importance, self.lut, m, self.ref_params, self.height,
                                          self.width, dtype=program)
            got.append(img)
            want.append(ref)
        return check.frame_numbers(got, want)

    def work_counts(self, i: int) -> dict:
        """The plain reference's step counts of frame i."""
        _, counts = reference.render(self.volume, self.importance, self.lut, self.matrices(i), self.ref_params,
                                     self.height, self.width)
        return counts


class FitJob(Job):
    #: whether the program's step yields its frame (``image_gap`` compares it)
    frames = True

    def __init__(self, cfg, mix, seed, device, backend):
        super().__init__(cfg, mix, seed, device, backend)
        # the targets: the reference's frames of the true scene from each view
        self.targets = [
            reference.render(self.volume, self.importance, self.lut, self.matrices(k), self.ref_params,
                             self.height, self.width)[0]
            for k in range(len(self.views))
        ]
        # the start of the program's ``fit``: a flat volume that clears the
        # threshold, and the scene's LUT
        start = mix["start"]
        level = max(float(start["floor"]), self.params.density_threshold + float(start["over_threshold"]))
        self.start = {"volume": torch.full_like(self.volume, level), "tf_lut": self.lut}
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.leaves = {k: self.start[k].detach().clone().requires_grad_() for k in mix["leaves"]}
        self.render = self._program()
        self.opt = torch.optim.Adam(list(self.leaves.values()), lr=float(mix["learning_rate"]))
        self.first: dict = {}
        self._reference: dict = {}
        self.offset = 0
        self.checked = traffic.sample_indices(seed + 3, 1, WINDOW_BELOW - 1)[0] + 1
        self.window: dict = {"losses": []}
        self.kept_up_to = -1

    def _program(self):
        """The program's differentiable renderer of the scene with the leaves."""
        from volym_tpu_torch.render import renderer
        from volym_tpu_torch.scene import Scene

        frozen = {"volume": self.volume, "importance": self.importance, "tf_lut": self.lut}
        frozen.update(self.leaves)
        return renderer.make_renderer(Scene(**frozen), self.params, self.height, self.width, backend=self.backend,
                                      device=self.device, differentiable=True)

    def _step(self, i: int):
        from volym_tpu_torch import optim

        self.opt.zero_grad(set_to_none=True)
        img = self.render(self.port_matrices(self.matrices(i)))
        loss = optim.l2_image_loss(img, self.targets[i % len(self.views)])
        self.image = img.detach()
        loss.backward()
        self.opt.step()
        with torch.no_grad():
            for leaf in self.leaves.values():
                leaf.clamp_(0.0, 1.0)
        return loss

    def warm_up(self):
        """The first steps, which the reference follows, then a round of
        every view; the window goes on from there with the same job."""
        before = {k: v.detach().clone() for k, v in self.leaves.items()}
        losses = []
        for s in range(FIT_CHECKED_STEPS):
            losses.append(self._step(s).item())
            if s == 0:  # the frame, and the first gradient as Adam holds it; none where it took no step
                if self.frames:
                    self.first["image"] = self.image.clone()
                beta1 = self.opt.param_groups[0]["betas"][0]
                self.first["grad"] = {
                    k: self.opt.state[v]["exp_avg"] / (1.0 - beta1) if "exp_avg" in self.opt.state[v]
                    else torch.zeros_like(v) for k, v in self.leaves.items()}
        self.first["losses"] = losses
        self.first["change"] = {k: v.detach() - before[k] for k, v in self.leaves.items()}
        del before
        self.offset = FIT_CHECKED_STEPS
        self.round_s = []  # each step's seconds in the round of every view
        for s in range(len(self.views)):
            t = time.perf_counter()
            self.sync(self._step(self.offset + s))
            self.round_s.append(time.perf_counter() - t)
        self.offset += len(self.views)

    def issue(self, i: int):
        return self._step(self.offset + i)

    def sync(self, loss):
        loss.item()

    def _adam(self, key: str) -> dict:
        return {k: self.opt.state[v][key].clone() if key in self.opt.state[v] else torch.zeros_like(v)
                for k, v in self.leaves.items()}

    def keep(self, i: int, loss):
        """Around the checked window steps j and j + 1: the leaves and
        Adam's state before j, Adam's first moment after j, both losses and
        the leaves after j + 1."""
        j, w = self.checked, self.window
        if i == j - 1:
            w["before"] = {k: v.detach().clone() for k, v in self.leaves.items()}
            w["exp_avg"], w["exp_avg_sq"] = self._adam("exp_avg"), self._adam("exp_avg_sq")
            first = next(iter(self.leaves.values()))
            w["t"] = int(self.opt.state[first]["step"]) if "step" in self.opt.state[first] else 0
            w["beta1"] = self.opt.param_groups[0]["betas"][0]
        elif j <= i < j + WINDOW_STEPS:
            w["losses"].append(loss.item())
            if i == j:
                w["exp_avg_after"] = self._adam("exp_avg")
                if self.frames:
                    w["image"] = self.image.clone()
            if i == j + WINDOW_STEPS - 1:
                w["after"] = {k: v.detach().clone() for k, v in self.leaves.items()}
        self.kept_up_to = i

    def finish(self, count: int) -> int:
        """Steps on past the window, through the same call, until the checked
        steps are done; -> the index of the next step."""
        i = count
        while self.kept_up_to < self.checked + WINDOW_STEPS - 1:
            loss = self.issue(i)
            self.sync(loss)
            self.keep(i, loss)
            i += 1
        return i

    def release(self):
        del self.render, self.opt, self.leaves

    def numbers(self, dtype=torch.float32, program=None) -> dict[str, float]:
        """The first steps and the checked window steps against the
        reference's, and, where the program's step yields its frame
        (``frames``), the frames of the first step and of the first checked
        window step (``image_gap``, the largest gap of any entry);
        ``program``: a dtype in which the reference takes the program's place
        (the control)."""
        want = self.reference_steps(torch.float32)
        got = self.first if program is None else self.reference_steps(program)
        out = check.fit_numbers(got, want)
        images = [(got.get("image"), want["image"])]
        want = self.reference_window(torch.float32)
        got = self.program_window() if program is None else self.reference_window(program)
        out.update({f"window_{k}": v for k, v in check.fit_numbers(got, want).items()})
        images.append((got.get("image"), want["image"]))
        if self.frames:
            out["image_gap"] = check.frame_numbers(*zip(*images))["frame_gap_max"]
        if program is None:  # how the work drifts from the start to the checked window step
            self.work_notes = {"work_first_step": self.reference_steps(torch.float32)["counts"],
                               f"work_window_step_{self.checked}": want["counts"]}
        return out

    def program_window(self) -> dict:
        """The checked window steps as the program ran them: the losses, the
        first gradient as Adam holds it (its first moment's update over 1 -
        beta1) and the leaves' change."""
        w, beta1 = self.window, self.window["beta1"]
        grad = {k: (w["exp_avg_after"][k] - beta1 * w["exp_avg"][k]) / (1.0 - beta1) for k in w["before"]}
        return {"losses": w["losses"], "grad": grad, "image": w.get("image"),
                "change": {k: w["after"][k] - w["before"][k] for k in w["before"]}}

    def reference_window(self, dtype, rows_per_block: int = 256) -> dict:
        """The reference's checked window steps in ``dtype``, from the
        program's leaves and Adam's state before them."""
        key = ("window", dtype, rows_per_block)
        if key in self._reference:
            return self._reference[key]
        w = self.window
        state = {k: (w["exp_avg"][k].to(dtype), w["exp_avg_sq"][k].to(dtype)) for k in w["before"]}
        opt = reference.Adam(float(self.mix["learning_rate"]), state=state, t=w["t"])
        params = {k: w["before"][k].to(dtype) for k in w["before"]}
        out = {"losses": []}
        for s in range(WINDOW_STEPS):
            i = self.offset + self.checked + s
            loss, d_vol, d_lut, image, counts = reference.loss_and_grads(
                params["volume"], self.importance, params["tf_lut"], self.matrices(i),
                self.targets[i % len(self.views)], self.ref_params, self.height, self.width, dtype=dtype,
                rows_per_block=rows_per_block)
            grads = {"volume": d_vol, "tf_lut": d_lut}
            if s == 0:
                out["grad"] = {k: grads[k] for k in params}
                out["counts"], out["image"] = counts, image
            out["losses"].append(loss)
            params = opt.step(params, grads)
        out["change"] = {k: params[k].float() - w["before"][k] for k in params}
        self._reference[key] = out
        return out

    def reference_steps(self, dtype, rows_per_block: int = 256) -> dict:
        """The reference's first steps from the same start, computed in
        ``dtype`` (kept: the control and the diagnostics read them again)."""
        if (dtype, rows_per_block) in self._reference:
            return self._reference[dtype, rows_per_block]
        opt = reference.Adam(float(self.mix["learning_rate"]))
        params = {k: self.start[k].to(dtype) for k in self.mix["leaves"]}
        out = {"losses": []}
        for s in range(FIT_CHECKED_STEPS):
            loss, d_vol, d_lut, image, counts = reference.loss_and_grads(
                params["volume"], self.importance, params["tf_lut"], self.matrices(s),
                self.targets[s % len(self.views)], self.ref_params, self.height, self.width, dtype=dtype,
                rows_per_block=rows_per_block)
            grads = {"volume": d_vol, "tf_lut": d_lut}
            if s == 0:
                out["grad"] = {k: grads[k] for k in params}
                out["counts"], out["image"] = counts, image
            out["losses"].append(loss)
            params = opt.step(params, grads)
        out["change"] = {k: params[k].float() - self.start[k] for k in params}
        self._reference[dtype, rows_per_block] = out
        return out

    def work_counts(self, i: int, state: dict) -> dict:
        """The plain reference's step counts of step i's forward, on the
        volume and LUT the step received."""
        _, counts = reference.render(state["volume"], self.importance, state["tf_lut"], self.matrices(self.offset + i),
                                     self.ref_params, self.height, self.width)
        return counts


class RanksFitJob(FitJob):
    """One rank of a fitting job over ``world`` processes, one a card: this
    process's part of ``make_train_step``'s step (its ``world``-th of the
    frame's pixel rows marched, the gradients all-reduced), then Adam and the
    projection, the same on every rank.  The step yields no frame, so the
    checks are the fit's without ``image_gap``.

    ``rank``, ``world``, ``coordinator`` ("host:port" of rank 0's store):
    the process group's layout, brought up through the program's
    ``maybe_initialize`` from the ``VOLYM_*`` variables; ``device`` "cuda"
    runs NCCL on card ``rank``, "cpu" gloo."""

    frames = False

    def __init__(self, cfg, mix, seed, device, backend, rank: int = 0, world: int = 1, coordinator: str = ""):
        from volym_tpu_torch.parallel import launch

        self.rank, self.world = rank, world
        env = {launch.ENV_COORDINATOR: coordinator, launch.ENV_NUM_PROCESSES: str(world),
               launch.ENV_PROCESS_ID: str(rank)}
        if int(cfg["height"]) % world:
            raise ValueError(f"{cfg['height']} pixel rows do not split into {world} shards of whole rows")
        self.timeout = launch.DEFAULT_TIMEOUT
        launch.maybe_initialize(True, device=device, env=env, timeout=self.timeout)
        super().__init__(cfg, mix, seed, launch.local_device(), backend)

    def inputs(self) -> list[torch.Tensor]:
        """What this rank made from the seed: the volumes, the LUT, the
        targets and the start."""
        return [self.volume, self.importance, self.volume_u8, self.lut, *self.targets, self.start["volume"]]

    def _program(self):
        """One train step per view: each fixes its march axis from the camera
        it is built with."""
        from volym_tpu_torch.parallel import mesh

        m = mesh.make_host_mesh([self.device])
        return [mesh.make_train_step(self.params, self.height, self.width, m, backend=self.backend,
                                     camera_matrices=self.port_matrices(self.matrices(v)))
                for v in range(len(self.views))]

    def _step(self, i: int):
        from volym_tpu_torch.scene import Scene

        v = i % len(self.views)
        scene = Scene(volume=self.leaves["volume"].detach(), importance=self.importance,
                      tf_lut=self.leaves["tf_lut"].detach())
        loss, grads = self.render[v](scene, self.port_matrices(self.matrices(i)), self.targets[v])
        for k, leaf in self.leaves.items():
            leaf.grad = getattr(grads, k)
        self.opt.step()
        with torch.no_grad():
            for leaf in self.leaves.values():
                leaf.clamp_(0.0, 1.0)
        return loss

    def rows(self) -> tuple[int, int]:
        """This rank's pixel rows of the frame, as the mesh's shards cut them."""
        per = self.height // self.world
        return self.rank * per, (self.rank + 1) * per

    def work_counts(self, i: int, state: dict) -> dict | None:
        """The plain reference's step counts of step i's forward over this
        rank's rows, on the volume and LUT the step received; rank 0's
        alone (the per-layer metrics read rank 0's trace)."""
        if self.rank != 0:
            return None
        p, cam = self.ref_params, self.matrices(self.offset + i)
        r0, r1 = self.rows()
        with torch.no_grad():
            g = reference.grids(state["volume"].float(), self.importance, p, cam["view"])
            camt = reference.cam_tensors(cam, self.device)
            ndc = reference.pixel_ndc(self.height, self.width, self.device)[r0 * self.width:r1 * self.width]
            f = reference.ray_table(camt, ndc, g, g.vol.shape[1])
            counts: dict[str, int] = {}
            gate = None
            if p.use_importance_rendering:
                cone = reference.cone_table(camt, ndc, g, g.vol.shape[1]) if p.use_cone_importance_check else None
                gate, gc = reference.lookahead_gate(f, cone, g.levels, g.sign, p.subtexel_bits)
                counts.update(gc)
            _, mc = reference.march(f, g, state["tf_lut"], p, gate)
            for k, v in mc.items():
                counts[k] = counts.get(k, 0) + v
        return {k: int(v) for k, v in counts.items()}


JOBS = {"view": ViewJob, "fit": FitJob, "fit_ranks": RanksFitJob}
