"""The interactive shell unit (port of ``znicz_tpu/interaction.py``).

``Shell`` opens an IPython session inside the running workflow (gate it,
say, to epoch ends) with the workflow in scope, or ``code.interact``
where IPython does not import; with ``interactive=False`` it only counts
its firings, so a headless run never blocks.
"""

from __future__ import annotations

from znicz_torch.core.units import Unit


class Shell(Unit):
    def __init__(self, workflow=None, name=None, interactive=True, **kwargs):
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.interactive = bool(interactive)
        self.invocations = 0

    def run(self):
        self.invocations += 1
        if not self.interactive:
            return
        ns = {"workflow": self.workflow, "unit": self}
        banner = (f"znicz-torch shell (workflow={self.workflow.name!r}); "
                  "objects: workflow, unit; Ctrl-D to continue training")
        try:
            from IPython import embed

            embed(banner1=banner, user_ns=ns, colors="neutral")
        except ImportError:
            import code

            code.interact(banner=banner, local=ns)
