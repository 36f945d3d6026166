"""ompi_tpu_torch info: the versions, frameworks, components, MCA
variables and pvars of the port.

The port of ``ompi_tpu/tools/info.py`` (reference: ompi/tools/ompi_info),
over the port's frameworks::

    python -m ompi_tpu_torch.tools.info              # everything, level <= 6
    python -m ompi_tpu_torch.tools.info --level 9    # developer variables too
    python -m ompi_tpu_torch.tools.info --param coll # one framework's vars
    python -m ompi_tpu_torch.tools.info --pvars      # performance variables
    python -m ompi_tpu_torch.tools.info --all        # level 9 and pvars
"""

from __future__ import annotations

import argparse
import sys

import torch


def _load_everything() -> None:
    """Import every module that registers a framework, component, variable
    or pvar."""
    import ompi_tpu_torch.accelerator  # noqa: F401 accelerator framework
    import ompi_tpu_torch.coll.persist  # noqa: F401 coll_persist_*, persist_*
    import ompi_tpu_torch.parallel.mesh  # noqa: F401 coll: mesh, quant
    import ompi_tpu_torch.quant  # noqa: F401 quant_* and their pvars
    import ompi_tpu_torch.runtime.spc  # noqa: F401 spc_enable
    import ompi_tpu_torch.runtime.trace  # noqa: F401 trace_* and pvars
    import ompi_tpu_torch.runtime.topology  # noqa: F401 topo_bind_ranks
    import ompi_tpu_torch.qos  # noqa: F401 qos_tag_map, btl_tcp_shape_*
    import ompi_tpu_torch.ft.inject  # noqa: F401 ft_inject_*, injected faults
    import ompi_tpu_torch.ft.detector  # noqa: F401 ft_enable, heartbeat vars
    import ompi_tpu_torch.runtime.metrics  # noqa: F401 metrics_* and pvars
    import ompi_tpu_torch.runtime.linkmodel  # noqa: F401 linkmodel_*
    import ompi_tpu_torch.runtime.forensics  # noqa: F401 forensics_*
    import ompi_tpu_torch.runtime.sanitizer  # noqa: F401 sanitizer_*
    import ompi_tpu_torch.runtime.progress  # noqa: F401 runtime_idle_block_us
    import ompi_tpu_torch.btl.self_btl  # noqa: F401 btl framework: self
    import ompi_tpu_torch.btl.sm  # noqa: F401 btl_sm_*
    import ompi_tpu_torch.btl.tcp  # noqa: F401 btl_tcp_* and their pvars
    import ompi_tpu_torch.coll.smcoll  # noqa: F401 coll: sm, coll_sm_*
    import ompi_tpu_torch.coll.han  # noqa: F401 coll: han, coll_han_*
    import ompi_tpu_torch.coll.hier.compose  # noqa: F401 coll: hier, coll_hier_*
    import ompi_tpu_torch.coll.adaptive  # noqa: F401 coll: adapt, coll_adapt_*


def print_header(out) -> None:
    from ompi_tpu_torch.version import __version__

    print(f"ompi_tpu_torch: {__version__}", file=out)
    print(f"python:   {sys.version.split()[0]}", file=out)
    print(f"torch:    {torch.__version__}", file=out)
    print(f"cuda:     {torch.version.cuda or 'unavailable'}", file=out)


def print_components(out) -> None:
    from ompi_tpu_torch.mca.component import all_frameworks

    print("\nframeworks / components "
          "(reference: ompi_info component list):", file=out)
    for fname, fw in sorted(all_frameworks().items()):
        comps = sorted(fw.components.values(), key=lambda c: -c.PRIORITY)
        names = ", ".join(f"{c.NAME} (priority {c.PRIORITY})"
                          for c in comps) or "-"
        print(f"  {fname:<14} {fw.description}", file=out)
        print(f"  {'':<14} components: {names}", file=out)


def print_vars(out, level: int, framework: str = "") -> None:
    from ompi_tpu_torch.mca.var import all_vars

    print(f"\nmca parameters (level <= {level}"
          + (f", framework '{framework}'" if framework else "") + "):",
          file=out)
    for _, var in sorted(all_vars().items()):
        if var.level > level:
            continue
        if framework and var.framework != framework:
            continue
        src = var.source.name.lower()
        print(f"  {var.full_name:<36} = {var.value!r:<14} "
              f"[{var.typ.__name__}, level {var.level}, source {src}]",
              file=out)
        if var.help:
            print(f"  {'':<36}   {var.help}", file=out)


def print_pvars(out) -> None:
    from ompi_tpu_torch.mca.var import all_pvars

    print("\nperformance variables (reference: MPI_T pvars / "
          "mca_base_pvar.c):", file=out)
    pvars = all_pvars()
    if not pvars:
        print("  (none recorded yet)", file=out)
    for _, pv in sorted(pvars.items()):
        print(f"  {pv.full_name:<36} = {pv.value!r}", file=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ompi_tpu_torch_info",
        description="Dump frameworks, components, and MCA parameters")
    ap.add_argument("--level", type=int, default=6,
                    help="max parameter level to show (1-9, default 6)")
    ap.add_argument("--param", default="",
                    help="restrict parameters to one framework")
    ap.add_argument("--pvars", action="store_true",
                    help="show performance variables")
    ap.add_argument("--all", action="store_true",
                    help="everything incl. level-9 params and pvars")
    opts = ap.parse_args(argv)
    if opts.all:
        opts.level, opts.pvars = 9, True

    _load_everything()
    out = sys.stdout
    print_header(out)
    print_components(out)
    print_vars(out, opts.level, opts.param)
    if opts.pvars:
        print_pvars(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
