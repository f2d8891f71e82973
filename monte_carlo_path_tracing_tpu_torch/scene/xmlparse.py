"""Minimal cg23 scene-XML parser: <light> elements and the <camera> block.

The reference parses only ``<light mtlname=... radiance="r,g,b">`` via pugixml
(Mylight.cpp:11-30) and *ignores* the camera block, hard-coding the pose in
main (quirk Q13, main.cpp:507-508). Here the full documented format
(README.md:338-344) is parsed so all BASELINE configs drive from scene files:

    <camera type="perspective" width="1280" height="720" fovy="20.1143">
        <eye x=".." y=".." z=".."/>
        <lookat x=".." y=".." z=".."/>
        <up x=".." y=".." z=".."/>
    </camera>
    <light mtlname="Light" radiance="r,g,b"/>

cg23 files are XML *fragments* (multiple top-level elements, no single root),
which xml.etree rejects — so they are wrapped in a synthetic root first.
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class ParsedCamera:
    eye: Tuple[float, float, float]
    lookat: Tuple[float, float, float]
    up: Tuple[float, float, float]
    fovy: float
    width: int
    height: int


@dataclasses.dataclass
class ParsedSceneXML:
    lights: Dict[str, Tuple[float, float, float]]  # mtlname -> radiance rgb
    camera: Optional[ParsedCamera]


def _vec(node: ET.Element) -> Tuple[float, float, float]:
    return (float(node.get("x", 0)), float(node.get("y", 0)), float(node.get("z", 0)))


def parse_scene_xml_text(text: str) -> ParsedSceneXML:
    # Strip any <?xml ...?> declaration, then wrap the fragment.
    text = re.sub(r"<\?xml[^>]*\?>", "", text)
    root = ET.fromstring(f"<cg23_root>{text}</cg23_root>")

    lights: Dict[str, Tuple[float, float, float]] = {}
    for ln in root.iter("light"):
        mtlname = ln.get("mtlname", "")
        rad = tuple(float(p) for p in ln.get("radiance", "0,0,0").split(","))
        if len(rad) != 3:
            raise ValueError(f"light radiance must be 'r,g,b': {ln.get('radiance')!r}")
        lights[mtlname] = rad  # type: ignore[assignment]

    camera = None
    cam = root.find("camera")
    if cam is not None:
        eye_n, lookat_n, up_n = cam.find("eye"), cam.find("lookat"), cam.find("up")
        if eye_n is None or lookat_n is None or up_n is None:
            raise ValueError("camera block must contain <eye>, <lookat>, <up>")
        camera = ParsedCamera(
            eye=_vec(eye_n),
            lookat=_vec(lookat_n),
            up=_vec(up_n),
            fovy=float(cam.get("fovy", 45.0)),
            width=int(cam.get("width", 1280)),
            height=int(cam.get("height", 720)),
        )
    return ParsedSceneXML(lights=lights, camera=camera)


def parse_scene_xml(path: str) -> ParsedSceneXML:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_scene_xml_text(f.read())
