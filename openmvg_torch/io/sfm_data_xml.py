"""`sfm_data.xml`: cereal's XML archive of the scene (counterpart:
openmvg_tpu/io/sfm_data_xml.py; openMVG sfm_data_io.cpp sends .xml through
the same cereal name/value tree as .json).  Byte-equal to the
reference's writer.

The tree is io/sfm_data.py's JSON document laid out as XML: a <cereal>
root, one element per name, and dynamic containers marked size="dynamic"
with <value0>, <value1>, ... children.
"""

import xml.etree.ElementTree as ET

from openmvg_torch.io.sfm_data import ALL, _doc_from_scene, _scene_from_doc

# leaves read back as text even when they look like numbers
_STRING_FIELDS = {"filename", "local_path", "root_path", "polymorphic_name",
                  "sfm_data_version"}
_CONTAINERS = ("views", "intrinsics", "extrinsics", "structure", "control_points")


def _to_elem(tag, value):
    e = ET.Element(tag)
    if isinstance(value, dict):
        for k, v in value.items():
            e.append(_to_elem(k, v))
    elif isinstance(value, (list, tuple)):
        e.set("size", "dynamic")
        for i, v in enumerate(value):
            e.append(_to_elem(f"value{i}", v))
    elif isinstance(value, bool):
        e.text = "true" if value else "false"
    else:
        e.text = str(value)
    return e


def _from_elem(e):
    kids = list(e)
    if e.get("size") == "dynamic" or (
            kids and kids[0].tag == "value0" and all(k.tag.startswith("value") for k in kids)):
        return [_from_elem(k) for k in kids]
    if kids:
        return {k.tag: _from_elem(k) for k in kids}
    t = (e.text or "").strip()
    if e.tag in _STRING_FIELDS:
        return t
    if t in ("true", "false"):
        return t == "true"
    for conv in (int, float):
        try:
            return conv(t)
        except ValueError:
            pass
    return t


def save_sfm_data_xml(scene, path, parts: int = ALL):
    root = ET.Element("cereal")
    for k, v in _doc_from_scene(scene, parts).items():
        root.append(_to_elem(k, v))
    ET.indent(root)
    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0" encoding="utf-8"?>\n')
        f.write(ET.tostring(root))
    return True


def load_sfm_data_xml(path, parts: int = ALL):
    doc = {k.tag: _from_elem(k) for k in ET.parse(path).getroot()}
    for key in _CONTAINERS:   # an empty container parses as ""
        if not isinstance(doc.get(key), list):
            doc[key] = []
    return _scene_from_doc(doc, parts)
