"""The window drives `kanzi_tpu_torch.decompress` on streams that set-up
wrote with `kanzi_tpu_torch.compress`, as a user restores what was stored.

Set-up writes each object as a KANZ stream on the card with the
configuration's Writer settings and decodes one batch of the largest and
the smallest stream. A call decodes one stream with the configuration's
`jobs`; a traced call does the same through a `Reader` with a block-event
listener. The checks (check.py) then hold the answers to the originals
and the streams to the plain reference.
"""

from __future__ import annotations

from portbench import check


class BlockEvents:
    """A Reader listener that keeps (event type, block id, time)."""

    def __init__(self):
        self.log = []

    def process_event(self, evt) -> None:
        self.log.append((evt.type.name, evt.block_id, evt.time))


class Decompress:
    def __init__(self, config, objects, device):
        import kanzi_tpu_torch as kt

        self.kt, self.config, self.objects, self.device = kt, config, objects, device
        self.jobs = config["jobs"]
        self.streams = [kt.compress(obj, transform=config["transform"],
                                    entropy=config["entropy"],
                                    block_size=config["block_size"], jobs=self.jobs,
                                    checksum=config["checksum"], device=device)
                        for obj in objects]
        by_size = sorted(range(len(objects)), key=lambda i: len(objects[i]))
        for i in dict.fromkeys((by_size[-1], by_size[0])):
            kt.decompress(self.streams[i], jobs=self.jobs, ctx={"to": self.jobs + 1},
                          device=device)
        self.events = []

    def decode(self, stream):
        return self.kt.decompress(stream, jobs=self.jobs, device=self.device)

    def call(self, i):
        return self.decode(self.streams[i])

    def traced(self, i):
        r = self.kt.Reader(self.streams[i], jobs=self.jobs, device=self.device)
        events = BlockEvents()
        r.add_listener(events)
        self.events.append(events.log)
        try:
            return r.read_all()
        finally:
            r.close()

    def judge(self, run, outputs, seed, checked) -> list:
        lays = check.layouts(self.streams)
        run.work = [check.work(lay) for lay in lays]
        run.events = self.events
        return check.judge(run, outputs, self.objects, self.streams, lays, self.decode,
                           self.config, seed, checked)


def setup(config, objects, device):
    return Decompress(config, objects, device)
